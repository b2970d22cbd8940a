"""EfficientNet-B0 end to end through the two-pass fused MBConv kernels,
or through the staged baseline.

Prints the per-block schedule table of full-size B0 (the Hopper tile,
retain/recompute, and the modeled fused against staged bytes), then runs a
width-scaled B0 forward and one backward with every MBConv block on the
fused kernels, or with ``--staged`` on the staged DW -> device memory ->
SE -> PW baseline.

    PYTHONPATH=src python -m repro_torch.examples.efficientnet_mbconv \\
        [--hw 32] [--staged] [--device cpu]

Counterpart of the JAX package's ``examples/efficientnet_mbconv.py``.  The
device defaults to CUDA and raises without it (TF32 is turned off there,
so the staged matmuls are fp32 like the kernels); ``--device cpu`` runs
the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..benchmarks.kernel_bench import block_traffic, family_chain
from ..configs.efficientnet_b0 import efficientnet_b0_smoke
from ..kernels.common import resolve_device
from ..models.mbconv import (
    effnet_block_specs,
    efficientnet_b0_apply,
    efficientnet_b0_def,
)
from ..models.param import count_params, materialize


def schedule_table(batch: int = 1) -> None:
    print(f"== EfficientNet-B0 two-pass fused MBConv schedules (224, batch "
          f"{batch}) ==")
    print(f"{'layer':<12}{'c_in':>5}{'c_mid':>6}{'c_out':>6}{'hw':>4}"
          f"{'k':>3}{'s':>3}{'tile':>7}{'mode':>11}{'saving':>8}")
    total_f = total_s = 0
    _, rows, schedules = family_chain("b0", batch, 224)
    for i, (r, sch) in enumerate(zip(rows, schedules)):
        fused, staged = block_traffic(r, sch, batch)
        total_f += fused.total_bytes
        total_s += staged.total_bytes
        saving = 1 - fused.total_bytes / staged.total_bytes
        print(f"{'b0_mbconv' + str(i):<12}{r.c_in:>5}{r.c_mid:>6}"
              f"{r.c_out:>6}{r.h:>4}{r.k:>3}{r.s:>3}"
              f"{f'{sch.tile_h}x{sch.tile_w}':>7}{sch.mode:>11}"
              f"{100 * saving:>7.1f}%")
    print(f"network total: fused {total_f / 1e6:.1f} MB vs staged "
          f"{total_s / 1e6:.1f} MB "
          f"({100 * (1 - total_f / total_s):.1f}% device-memory traffic "
          f"avoided, modeled)\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", type=int, default=32,
                    help="input resolution for the smoke forward/backward")
    ap.add_argument("--staged", action="store_true",
                    help="route MBConv blocks through the staged "
                         "DW->memory->SE->PW baseline instead of the "
                         "two-pass fused kernels")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    schedule_table()

    cfg = efficientnet_b0_smoke()
    params = materialize(efficientnet_b0_def(cfg),
                         torch.Generator().manual_seed(0), device)
    specs = effnet_block_specs(cfg)
    print(f"smoke B0: width x{cfg.width_mult}, {len(specs)} MBConv blocks, "
          f"{count_params(efficientnet_b0_def(cfg)):,} params, "
          f"input {args.hw}x{args.hw}")

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, args.hw, args.hw, 3))
                         .astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, cfg.num_classes, (2,))).to(device)
    fused = not args.staged

    with torch.no_grad():
        logits = efficientnet_b0_apply(params, x, cfg, fused=fused)
    print(f"forward: logits {tuple(logits.shape)}, "
          f"finite={bool(torch.isfinite(logits).all())}")

    leaves = [t.requires_grad_() for t in _leaves(params)]
    loss = F.cross_entropy(efficientnet_b0_apply(params, x, cfg,
                                                 fused=fused), y)
    grads = torch.autograd.grad(loss, leaves)
    gnorm = torch.sqrt(sum((g ** 2).sum() for g in grads))
    path = "staged" if args.staged else "two-pass fused"
    print(f"backward: loss {float(loss.detach()):.3f}, grad norm "
          f"{float(gnorm):.3f} — every MBConv block ran the {path} "
          f"pipeline on {device}")
    return 0


def _leaves(tree: dict):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]


if __name__ == "__main__":
    main()
