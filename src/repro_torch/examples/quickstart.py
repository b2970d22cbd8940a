"""Quickstart: the paper's ConvDK dataflow in five minutes.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Counterpart of the JAX package's ``examples/quickstart.py``: the
schedule's number theory, ConvDK against a plain depthwise conv, the
BIG/LITTLE macro plan, the buffer-traffic cut, and the depthwise kernel
(``kernels/csrc/separable.cu``) over staged strips.  The tensors run on
CUDA by default (raising without it); ``--device cpu`` runs the kernel's
plain PyTorch version.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.convdk import dwconv2d_convdk, dwconv2d_oracle
from ..core.perfmodel import cost_ws_base, cost_ws_convdk, reduction
from ..core.schedule import is_exact_cover, make_schedule
from ..core.tiling import DWLayer, plan_layer
from ..kernels import convdk_depthwise2d
from ..kernels.common import resolve_device
from ..kernels.ref import depthwise2d_ref


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    device = resolve_device(ap.parse_args(argv).device)

    # 1. The number theory: the paper's worked example (k=3, s=2, N=30).
    sched = make_schedule(k=3, s=2, N=30)
    print(f"ConvDK schedule k=3 s=2 N=30: l={sched.l} shift cycles, "
          f"m1={sched.m1}, n1={sched.n1}")
    print(f"  cycle a=0 computes outputs m = {sched.cycles[0].ms[:5]}...")
    print(f"  Theorem 2 exact cover: {is_exact_cover(sched)}")

    # 2. ConvDK computes the SAME depthwise conv, with one strip load per row.
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, 24, 24)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(8, 3, 3)).astype(np.float32))
    x, k = x.to(device), k.to(device)
    out_dk = dwconv2d_convdk(x, k, stride=1, padding="SAME")
    out_ref = dwconv2d_oracle(x, k, stride=1, padding="SAME")
    print(f"\nConvDK == grouped conv2d: "
          f"{bool(torch.allclose(out_dk, out_ref, atol=1e-4))}")

    # 3. The BIG/LITTLE scheduler picks the macro plan (Fig. 5's example).
    plan = plan_layer(DWLayer(c=128, h=24, w=24, k=3, s=1))
    print(f"\n128x24x24 DWConv -> {plan.mode} scheduler, N_ch={plan.n_ch}, "
          f"TM utilization {plan.tm_utilization:.0%}")

    # 4. Buffer traffic: the paper's headline.
    layer = DWLayer(c=512, h=14, w=14, k=3, s=1)
    base, ours = cost_ws_base(layer), cost_ws_convdk(layer)
    print(f"512x14x14: buffer traffic {base.buffer_words} -> "
          f"{ours.buffer_words} words "
          f"({reduction(base.buffer_words, ours.buffer_words):.1f}% less)")

    # 5. The Hopper depthwise kernel over staged row strips (its plain
    #    version on the CPU): channels on the lanes, k shifted re-reads.
    xb = torch.from_numpy(rng.normal(size=(2, 14, 14, 32)).astype(np.float32))
    kb = torch.from_numpy(rng.normal(size=(3, 3, 32)).astype(np.float32))
    xb, kb = xb.to(device), kb.to(device)
    got = convdk_depthwise2d(xb, kb, stride=1, padding="SAME")
    want = depthwise2d_ref(xb, kb, stride=1, padding="SAME")
    print(f"\ndepthwise kernel on {device} == oracle: "
          f"{bool(torch.allclose(got, want, atol=1e-4))}")
    return 0


if __name__ == "__main__":
    main()
