"""Causal depthwise Conv1D (+ bias, optional SiLU) through a hand-written
CUDA kernel.

Counterpart of ``repro.kernels.convdk_conv1d``: ``conv1d`` computes

    out[b, t, d] = act(bias[d] + sum_i w[i, d] * x[b, t - k + 1 + i, d])

with x zero before t = 0, in one launch of ``causal_conv1d_kernel``
(``kernels/csrc/conv1d.cu``) for CUDA tensors and ``conv1d_plain`` for CPU
tensors; any other device raises.  ``LAUNCHES`` counts kernel launches.
The kernel reads the unstaged (B, L, D) input and loads each walk's causal
halo itself, so the strips the JAX wrapper stages in HBM
(``kernels.ops.stage_seq_strips``) are never written; ragged channel counts
and unaligned pointers take its masked scalar loads, so nothing is padded.
Its launch geometry is the card's, not the JAX tile's: ``conv1d_plan``
cuts (B, L, D) into short walks of one 16-byte channel group each, as many
as fill whole waves of the card's SMs.

x is fp32 or bf16; the weights and bias are taken in fp32 and the sum is
fp32, rounded once to x's dtype, as the Pallas kernel computes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .common import ACT_CODES, FP32, check_cuda, on_cpu, ptr
from .ref import _act_ref

KERNELS: Tuple[str, ...] = ("conv1d",)
# kernel launches per wrapper (reset with ``reset_launches``)
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)
ACTIVATIONS = (None, "silu")
X_DTYPES: Tuple[torch.dtype, ...] = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int

# the design's constants (conv1d.cu; ``_lib`` checks them against it)
NTHREADS = 128         # threads a CTA
RESIDENT_CTAS = 4      # CTAs an SM holds (the kernel's register cap)
RING = 8               # rows a thread has requested ahead (its smem ring)
GROUP_BYTES = 16       # one thread's channels in a row: one vector load
WALK_MAX = 48          # rows a thread walks at most
WAVE_FILL = 0.95       # the share of the last wave's CTAs a plan fills


class Conv1dPlan(NamedTuple):
    """One launch's geometry: a CTA covers ``groups_per_cta`` channel groups
    (``GROUP_BYTES`` each) x ``NTHREADS // groups_per_cta`` walks of
    ``walk`` rows; the grid is ``(blocks_d, blocks_l, B)`` CTAs."""
    groups_per_cta: int
    walk: int
    blocks_d: int
    blocks_l: int
    batch: int

    @property
    def walks_per_cta(self) -> int:
        return NTHREADS // self.groups_per_cta

    @property
    def ctas(self) -> int:
        return self.blocks_d * self.blocks_l * self.batch


def _wave_fill(ctas: int, wave: int) -> float:
    """The share of its whole waves' CTA slots a grid of ``ctas`` fills."""
    return ctas / (-(-ctas // wave) * wave)


def conv1d_plan(b: int, l: int, d: int, elt: int, n_sm: int) -> Conv1dPlan:
    """The launch plan of ``conv1d`` at x (b, l, d) of ``elt``-byte
    elements on a card of ``n_sm`` SMs.  A thread owns one group of
    ``GROUP_BYTES // elt`` channels; a CTA takes up to NTHREADS groups and
    stacks walks along L with its other threads.  The walk is the longest
    of at most WALK_MAX rows whose grid fills its last wave of ``n_sm`` x
    RESIDENT_CTAS CTAs to WAVE_FILL, else the one that fills it best (the
    longer of equals): long walks re-read fewer halo rows, short ones put
    every SM to work at small (B, L, D)."""
    return _plan(b, l, d, elt, n_sm, NTHREADS, RESIDENT_CTAS)


@functools.lru_cache(maxsize=None)
def _plan(b: int, l: int, d: int, elt: int, n_sm: int, nthreads: int,
          resident: int) -> Conv1dPlan:
    """``conv1d_plan`` for a build of ``conv1d.cu`` with CTAs of
    ``nthreads`` threads, ``resident`` of them an SM; cached, as every
    launch asks for its plan."""
    if min(b, l, d, elt, n_sm) < 1:
        raise ValueError(f"no conv1d plan for x ({b}, {l}, {d}) of {elt}-byte "
                         f"elements on {n_sm} SMs")
    groups = -(-d // (GROUP_BYTES // elt))
    gc = min(groups, nthreads)
    walks, blocks_d = nthreads // gc, -(-groups // gc)
    wave = n_sm * resident
    best = None
    for walk in range(min(WALK_MAX, -(-l // walks)), 0, -1):
        blocks_l = -(-l // (walks * walk))
        if blocks_l > 65535:                 # the grid's y limit
            break
        fill = _wave_fill(blocks_d * blocks_l * b, wave)
        if best is None or fill > best[0]:
            best = (fill, walk, blocks_l)
        if fill >= WAVE_FILL:
            break
    if best is None:                         # walks past WALK_MAX: very long L
        walk = -(-l // (walks * 65535))
        best = (0.0, walk, -(-l // (walks * walk)))
    return Conv1dPlan(gc, best[1], blocks_d, best[2], b)


def plan_info(plan: Conv1dPlan, l: int, d: int, k: int, elt: int,
              n_sm: int) -> Dict[str, float]:
    """What a plan puts on the card, as arithmetic (nothing here is
    measured): its CTAs, waves and last-wave fill, the bytes its threads
    request ahead while a full wave of RESIDENT_CTAS CTAs an SM runs
    (``conv1d.cu``: a thread's ring of min(walk, RING) rows, and its k - 1
    halo rows at the walk's start) and the halo rows' share of the
    loads."""
    wave = n_sm * RESIDENT_CTAS
    rows = min(plan.walk, l)
    walks = plan.batch * -(-d // (GROUP_BYTES // elt)) * -(-l // plan.walk)
    threads = walks * min(1.0, wave / plan.ctas)
    return {"ctas": plan.ctas, "waves": plan.ctas / wave,
            "wave_fill": _wave_fill(plan.ctas, wave), "walk": plan.walk,
            "modeled_bytes_requested_ahead":
                threads * (min(rows, RING) + k - 1) * GROUP_BYTES,
            "halo_share": (k - 1) / (rows + k - 1)}


def conv1d_cost(b: int, l: int, d: int, k: int, elt: int,
                activation: Optional[str]) -> Tuple[int, int]:
    """(bytes, fp32 operations) of one call on x (b, l, d) of ``elt``-byte
    elements: x read and the output written once, the fp32 taps and bias
    read once; a multiply and an add a tap, and 5 operations of the SiLU
    (negate, exp, add, reciprocal, multiply) an output."""
    n = b * l * d
    return (2 * elt * n + 4 * (k * d + d),
            (2 * k + (5 if activation == "silu" else 0)) * n)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/conv1d.cu`` built and bound."""
    lib = _build.load("conv1d")
    lib.causal_conv1d.argtypes = [_P] * 4 + [_I] * 10 + [_P]
    lib.causal_conv1d.restype = ctypes.c_int
    lib.conv1d_error_string.argtypes = [ctypes.c_int]
    lib.conv1d_error_string.restype = ctypes.c_char_p
    lib.conv1d_resident_ctas.argtypes = [_I] * 3
    lib.conv1d_resident_ctas.restype = ctypes.c_int
    consts = (ctypes.c_int * 3)()
    lib.conv1d_constants(consts)
    if tuple(consts) != (NTHREADS, RESIDENT_CTAS, RING):
        raise RuntimeError(f"conv1d.cu's NTHREADS, CTAS_PER_SM, RING "
                           f"{tuple(consts)} are not the plan's "
                           f"{(NTHREADS, RESIDENT_CTAS, RING)}")
    return lib


def _check_shapes(x, w, bias, activation, tile_l: int) -> None:
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} (B, L, D) and w "
                         f"{tuple(w.shape)} (k, D) do not fit")
    if bias is not None and tuple(bias.shape) != (x.shape[2],):
        raise ValueError(f"bias {tuple(bias.shape)} is not ({x.shape[2]},)")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, got "
                         f"{activation!r}")
    if tile_l < 1:
        raise ValueError(f"tile_l must be >= 1, got {tile_l}")


def conv1d_plain(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None) -> torch.Tensor:
    """Plain version of ``conv1d``: the taps summed in fp32 in the kernel's
    order, then the bias and the activation, rounded once to x's dtype."""
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    acc = xp[:, 0:l] * w[0].float()
    for i in range(1, k):
        acc = acc + xp[:, i:i + l] * w[i].float()
    if bias is not None:
        acc = acc + bias.float()
    return _act_ref(acc, activation).to(x.dtype)


def conv1d(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           activation: Optional[str] = None,
           tile_l: int = 512) -> torch.Tensor:
    """x (B, L, D), w (k, D), bias (D,) or None -> (B, L, D) in x's dtype.
    ``tile_l`` is the JAX wrapper's L tile, checked and kept for its API; it
    bounds nothing here: ``conv1d_plan`` cuts L by the card's SMs."""
    _check_shapes(x, w, bias, activation, tile_l)
    if on_cpu(x):
        return conv1d_plain(x, w, bias, activation)
    b, l, d = x.shape
    w32 = w.float().contiguous()
    b32 = None if bias is None else bias.float().contiguous()
    check_cuda(x, dtypes=X_DTYPES, align=x.element_size())
    check_cuda(w32, b32, dtypes=FP32, align=4)
    out = torch.empty_like(x)
    plan = conv1d_plan(b, l, d, x.element_size(), sm_count(x.device.index))
    lib = _lib()
    err = lib.causal_conv1d(
        ptr(x), ptr(w32), ptr(b32), ptr(out), b, l, d, w.shape[0],
        ACT_CODES[activation], int(x.dtype == torch.bfloat16),
        plan.groups_per_cta, plan.walk, plan.blocks_d, plan.blocks_l,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"causal_conv1d (k {w.shape[0]}, B {b}, L {l}, "
                           f"D {d}, {plan}) did not launch: "
                           f"{lib.conv1d_error_string(err).decode()}")
    LAUNCHES["conv1d"] += 1
    return out
