"""Host-clock time of one network forward on the card: EfficientNet-B0 at
224, MobileNet-V3-Large at 224 and EfficientNet-V2-S at 384, full width,
seeded random weights, through the fused kernels.

B0 and V3 at batch 8 leave the card idle most of the time, so their
forward is the host's Python and launch time; this script is how two
trees' host paths are compared.  It imports only the applies every slice
of the port has, so it times whichever ``repro_torch`` is on the path::

    PYTHONPATH=<tree>/src python src/repro_torch/benchmarks/forward_bench.py

Each network is warmed by WARM forwards, then timed in REPS rounds of
ITERS forwards, the card synchronized at each round's ends, on two clocks: the
wall clock, and the CPU time of the calling thread, which leaves out the
time the thread waits for a core that another process holds (a card's
host is shared).  The last line is a JSON object of per-forward ms per
network and clock (every round, their median and minimum) beside the
card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

from repro_torch.kernels import _build
from repro_torch.models import mbconv as tm
from repro_torch.models.param import materialize

NETS = (("b0", tm.EffNetConfig, tm.efficientnet_b0_def,
         tm.efficientnet_b0_apply, 224),
        ("v3", tm.MobileNetV3Config, tm.mobilenet_v3_def,
         tm.mobilenet_v3_apply, 224),
        ("v2s", tm.EffNetV2Config, tm.efficientnet_v2_s_def,
         tm.efficientnet_v2_s_apply, 384))
BATCH, WARM, REPS, ITERS = 8, 3, 7, 20


def time_forward(apply, params, images, cfg, reps: int, iters: int):
    """Per-forward ms of ``reps`` rounds of ``iters`` forwards each, on
    the wall clock and on the thread's CPU clock."""
    wall, cpu = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        for _ in range(iters):
            apply(params, images, cfg)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3 / iters)
        cpu.append((time.thread_time() - c0) * 1e3 / iters)
    return {"wall": wall, "thread_cpu": cpu}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the forwards time the card")
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["mbconv", "fusedmb", "separable"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    result = {"card": card, "batch": BATCH, "iters": ITERS, "ms": {}}
    with torch.inference_mode():
        for name, cfg_cls, def_fn, apply, side in NETS:
            cfg = cfg_cls()
            params = materialize(def_fn(cfg),
                                 torch.Generator().manual_seed(0), "cuda")
            images = torch.rand(BATCH, side, side, 3,
                                generator=torch.Generator().manual_seed(1)
                                ).cuda()
            for _ in range(WARM):
                apply(params, images, cfg)
            clocks = time_forward(apply, params, images, cfg, REPS, ITERS)
            result["ms"][name] = {
                clock: {"rounds": ms, "median": statistics.median(ms),
                        "min": min(ms)} for clock, ms in clocks.items()}
            print(f"{name} {side} b{BATCH}: per-forward ms "
                  + "; ".join(f"{clock} median {statistics.median(ms)!r} "
                              f"min {min(ms)!r}"
                              for clock, ms in clocks.items()), flush=True)
            del params, images
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
