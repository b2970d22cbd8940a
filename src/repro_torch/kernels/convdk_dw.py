"""Depthwise Conv2D over pre-staged row strips through a hand-written CUDA
kernel.

Counterpart of ``repro.kernels.convdk_dw``: ``dw2d`` runs the depthwise
k x k / s conv over the overlapping row strips that
``kernels.ops.stage_row_strips`` writes to device memory (the staged
baseline's IB->TRF analogue), one launch for CUDA tensors and
``dw2d_plain`` for CPU tensors; any other device raises.  The strips and
taps are fp32 or bf16 (one dtype for both); the sums are fp32 and the
output is rounded once to that dtype, as the Pallas kernel writes
``o_ref.dtype``.  fp32 launches ``dw2d_kernel`` (``kernels/csrc/
separable.cu``), counted as ``dw2d``; bf16 launches ``dw2d_bf16_kernel``
at the shape ``dw2d_bf16_plan`` solves, counted as ``dw2d_bf16``.  Ragged
channel counts are masked in the kernels, so nothing is padded to a
channel block.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from .common import check_cuda, launch_name, on_cpu, ptr
from .convdk_fused import _lib, launch_error
from .ref import depthwise_valid

KERNELS: Tuple[str, ...] = ("dw2d", "dw2d_bf16")
DTYPES: Tuple[torch.dtype, ...] = (torch.float32, torch.bfloat16)
# kernel launches per wrapper (reset with ``reset_launches``)
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

# the bf16 kernel's limits (separable.cu: DWB_THREADS, dw_run_ok; the C
# entry refuses any other plan)
DW_BF16_RUNS = (1, 2, 4)
DW_BF16_MAX_THREADS = 256
# the plan's candidates (``dw2d_bf16_plans``): channels a CTA (these, and
# the even splits of C of ``_even_cpts``), output rows a CTA, runs a row
DW_BF16_CPTS = (8, 16, 32, 64, 128, 256)
DW_BF16_EVEN_CPT = 128
DW_BF16_ROWS = (1, 2, 4, 8, 16)
DW_BF16_RUNS_PER_ROW = (1, 2, 4, 8, 16)
# the plan's rule, fitted to the card's sweep (``kernel_bench --dw2d``):
# the run at stride 1 and 2, the widest channel block, the most threads
DW_BF16_PLAN_RUN = (4, 1)           # at stride 1, 2
DW_BF16_PLAN_CPT = 64
DW_BF16_PLAN_THREADS = 128


class DwPlan(NamedTuple):
    """One bf16 launch's shape (separable.cu ``DwPlan``): ``run`` output
    pixels of a row a thread (8 channels); a CTA covers ``cpt`` channels,
    ``rows`` output rows of one strip and ``runs`` runs along each row."""
    run: int
    cpt: int
    rows: int
    runs: int

    @property
    def threads(self) -> int:
        return self.cpt // 8 * self.rows * self.runs


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def dw2d_bf16_launchable(plan: DwPlan) -> bool:
    """What the C entry takes: a run of DW_BF16_RUNS, whole 8-channel
    groups, at most DW_BF16_MAX_THREADS threads."""
    return (plan.run in DW_BF16_RUNS and plan.cpt > 0 and plan.cpt % 8 == 0
            and plan.rows > 0 and plan.runs > 0
            and plan.threads <= DW_BF16_MAX_THREADS)


def dw2d_bf16_grid(b: int, n_th: int, tile_h: int, out_w: int, c: int,
                   plan: DwPlan) -> Tuple[int, int, int]:
    """The launch's grid: (channel blocks x column blocks, strips x row
    blocks, images)."""
    n_runs = -(-out_w // plan.run)
    return (-(-c // plan.cpt) * -(-n_runs // plan.runs),
            n_th * -(-tile_h // plan.rows), b)


def _even_cpts(c: int, most: int) -> List[int]:
    """Channel blocks of whole 8-channel groups that split C's groups
    evenly, at most ``most`` channels."""
    groups = -(-c // 8)
    return [8 * d for d in range(1, groups + 1)
            if groups % d == 0 and 8 * d <= most]


def dw2d_bf16_plans(b: int, n_th: int, tile_h: int, out_w: int, c: int,
                    k: int, s: int) -> List[DwPlan]:
    """The launch shapes the sweep times and the plan chooses from: every
    run up to out_w, channel blocks of DW_BF16_CPTS below C and the
    even splits of C up to DW_BF16_EVEN_CPT channels (and the whole C up to
    DW_BF16_CPTS' last), rows of DW_BF16_ROWS up to tile_h (and tile_h),
    runs a row of DW_BF16_RUNS_PER_ROW up to the row's runs (and exactly
    the row's runs), at most DW_BF16_MAX_THREADS threads a CTA and, at each
    run and channel block, at least 32 (fewer only where none of them
    reaches 32: then the most it reaches).  k and s are the kernel's and
    take no part in the shapes."""
    groups = -(-c // 8)
    cpts = sorted({q for q in DW_BF16_CPTS if q < 8 * groups}
                  | set(_even_cpts(c, DW_BF16_EVEN_CPT))
                  | {q for q in (8 * groups,) if q <= DW_BF16_CPTS[-1]})
    rows_c = sorted({q for q in DW_BF16_ROWS if q < tile_h} | {tile_h})
    out = []
    for run in [r for r in DW_BF16_RUNS if r <= out_w]:
        n_runs = -(-out_w // run)
        along = sorted({q for q in DW_BF16_RUNS_PER_ROW if q < n_runs}
                       | {n_runs})
        for cpt in cpts:
            shapes = [p for rows in rows_c for runs in along
                      for p in (DwPlan(run, cpt, rows, runs),)
                      if dw2d_bf16_launchable(p)]
            least = min(32, max(p.threads for p in shapes))
            out += [p for p in shapes if p.threads >= least]
    return out


def _dw2d_bf16_rule(b: int, n_th: int, tile_h: int, out_w: int, c: int,
                    k: int, s: int, run_at: Tuple[int, int], most_cpt: int,
                    most_threads: int) -> DwPlan:
    """The plan's rule at its constants (``dw2d_bf16_plan``'s, or the fit's
    search): the run ``run_at`` gives the stride (at stride 1, 2; at most
    out_w), the widest channel block of whole 8-channel groups that splits
    C evenly within ``most_cpt`` channels, then, among
    ``dw2d_bf16_plans``' rows and runs a CTA with at most ``most_threads``
    threads (or any, where none has so few), the fewest CTAs, ties to the
    most rows."""
    run = max(r for r in DW_BF16_RUNS
              if r <= min(run_at[min(s, 2) - 1], out_w))
    cpt = max(_even_cpts(c, most_cpt))
    cands = [p for p in dw2d_bf16_plans(b, n_th, tile_h, out_w, c, k, s)
             if p.run == run and p.cpt == cpt]
    fit = [p for p in cands if p.threads <= most_threads] or cands
    return min(fit, key=lambda p: (
        math.prod(dw2d_bf16_grid(b, n_th, tile_h, out_w, c, p)), -p.rows))


@functools.lru_cache(maxsize=None)
def dw2d_bf16_plan(b: int, n_th: int, tile_h: int, out_w: int, c: int,
                   k: int, s: int) -> DwPlan:
    """The launch shape of the bf16 kernel: ``_dw2d_bf16_rule`` at
    DW_BF16_PLAN_RUN, DW_BF16_PLAN_CPT and DW_BF16_PLAN_THREADS, fitted to
    the card's sweep (``kernel_bench --dw2d``, ``PERF.md`` §6).
    Cached: the wrapper solves it on every call."""
    return _dw2d_bf16_rule(b, n_th, tile_h, out_w, c, k, s, DW_BF16_PLAN_RUN,
                           DW_BF16_PLAN_CPT, DW_BF16_PLAN_THREADS)


def _check_shapes(x_strips, w, stride: int, out_w: int, tile_h: int) -> None:
    _, _, in_rows, w_pad, c = x_strips.shape
    k_h, k_w, c_w = w.shape
    if k_h != k_w or c_w != c:
        raise ValueError(f"w {tuple(w.shape)} does not fit strips "
                         f"{tuple(x_strips.shape)}")
    if in_rows != (tile_h - 1) * stride + k_h \
            or w_pad < (out_w - 1) * stride + k_w:
        raise ValueError(f"strips {tuple(x_strips.shape)} do not cover "
                         f"tile_h {tile_h} x out_w {out_w} at stride "
                         f"{stride}")


def dw2d_plain(x_strips: torch.Tensor, w: torch.Tensor, *, stride: int,
               out_w: int, tile_h: int) -> torch.Tensor:
    """Plain version of ``dw2d``: an unpadded depthwise conv per strip,
    summed in fp32 and rounded once to the strips' dtype."""
    b, n_th, in_rows, w_pad, c = x_strips.shape
    out = depthwise_valid(
        x_strips.reshape(b * n_th, in_rows, w_pad, c).float(), w.float(),
        stride)
    return out[:, :, :out_w].reshape(b, n_th, tile_h, out_w, c) \
        .to(x_strips.dtype)


def dw2d(x_strips: torch.Tensor, w: torch.Tensor, *, stride: int,
         out_w: int, tile_h: int, plan: DwPlan = None) -> torch.Tensor:
    """x_strips (B, n_th, (tile_h-1)*s + k, W_pad, C), w (k, k, C) ->
    (B, n_th, tile_h, out_w, C).  ``plan`` pins the bf16 launch's shape
    (default ``dw2d_bf16_plan``); fp32 takes none."""
    _check_shapes(x_strips, w, stride, out_w, tile_h)
    if on_cpu(x_strips):
        return dw2d_plain(x_strips, w, stride=stride, out_w=out_w,
                          tile_h=tile_h)
    check_cuda(x_strips, w, dtypes=DTYPES)
    if w.dtype != x_strips.dtype:
        raise ValueError(f"strips {x_strips.dtype} and taps {w.dtype}: the "
                         f"kernel takes one dtype")
    b, n_th, in_rows, w_pad, c = x_strips.shape
    k = w.shape[0]
    bf16 = x_strips.dtype == torch.bfloat16
    if not bf16 and plan is not None:
        raise ValueError("the fp32 depthwise kernel takes no plan")
    if bf16 and plan is None:
        plan = dw2d_bf16_plan(b, n_th, tile_h, out_w, c, k, stride)
    out = torch.empty((b, n_th, tile_h, out_w, c), device=x_strips.device,
                      dtype=x_strips.dtype)
    lib = _lib()
    launch_error(lib, "dw2d", lib.dw2d(
        ptr(x_strips), ptr(w), ptr(out), b, n_th, in_rows, w_pad, c, k,
        stride, tile_h, out_w, int(bf16), *(plan or (0,) * 4),
        torch.cuda.current_stream().cuda_stream))
    LAUNCHES[launch_name("dw2d", x_strips.dtype)] += 1
    return out
