"""Executable ConvDK (convolution with duplicated kernels) in PyTorch.

Counterpart of ``repro.core.convdk``: it *numerically executes* the
paper's Algorithms 1-2 with the data movement of the CIM macro:

* the kernel is duplicated ``N`` times along the stationary dimension (the
  role of the Tile Memory, TM);
* one IA strip is loaded once (the role of the Tile Register File, TRF) and
  re-read at ``l = lcm(k,s)/s`` static shift offsets ``a``;
* each shift cycle performs all block dot-products in parallel (the parallel
  bitlines of the TM) and the multiplication-enable mask ``e_n`` selects the
  blocks whose results are valid outputs for that shift (Theorem 1).

These are tensor operations, not a kernel: the reference semantics of the
dataflow, run on whatever device their inputs lie on and differentiable
through autograd (every write is an out-of-place ``index_copy`` or
concatenation).  ``dwconv2d_oracle`` is the plain grouped convolution they
are held against.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .schedule import ConvDKSchedule, duplication_number, make_schedule


def _cycle_index(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.long, device=device)


# ---------------------------------------------------------------------------
# 1-D ConvDK (Algorithm 1)
# ---------------------------------------------------------------------------

def convdk_1d(kernel: torch.Tensor, ia: torch.Tensor,
              sched: ConvDKSchedule) -> torch.Tensor:
    """1-D ConvDK (Algorithm 1): ``z = kernel * ia`` with stride ``sched.s``.

    kernel : (k,) weights.
    ia     : (sched.ia_len,) input-activation strip.
    Returns (sched.out_len,) strided convolution output.
    """
    k, n = sched.k, sched.N
    if tuple(kernel.shape) != (k,):
        raise ValueError(f"kernel shape {tuple(kernel.shape)} != ({k},)")
    if ia.shape[-1] != sched.ia_len:
        raise ValueError(f"ia length {ia.shape[-1]} != {sched.ia_len}")
    z = ia.new_zeros((sched.out_len,),
                     dtype=torch.promote_types(kernel.dtype, ia.dtype))
    for cyc in sched.cycles:          # static loop over l shift cycles
        # the TM computes all N block results at once; block n sees the IA
        # window [a + n*k, a + n*k + k)
        windows = ia[cyc.a:cyc.a + n * k].reshape(n, k)
        y = windows @ kernel
        if cyc.ns:
            # e_n mask: only blocks in cyc.ns are enabled; their results
            # land at outputs cyc.ms (disjoint across cycles, Theorem 2)
            z = z.index_copy(0, _cycle_index(cyc.ms, z.device),
                             y[_cycle_index(cyc.ns, z.device)])
    return z


# ---------------------------------------------------------------------------
# 2-D strip ConvDK (Eq. 7 — one (channel, output-row) strip in one tile)
# ---------------------------------------------------------------------------

def _strip_outputs(kernel: torch.Tensor, strips: torch.Tensor,
                   sched: ConvDKSchedule) -> torch.Tensor:
    """Eq. (7) over a batch of strips: kernel (..., k_h, k) and strips
    (..., k_h, ia_len) with matching leading dims -> (..., out_len)."""
    k, n = sched.k, sched.N
    lead, k_h = strips.shape[:-2], strips.shape[-2]
    z = strips.new_zeros((*lead, sched.out_len),
                         dtype=torch.promote_types(kernel.dtype,
                                                   strips.dtype))
    for cyc in sched.cycles:
        windows = strips[..., cyc.a:cyc.a + n * k].reshape(*lead, k_h, n, k)
        y = torch.einsum("...jni,...ji->...n", windows, kernel)
        if cyc.ns:
            z = z.index_copy(-1, _cycle_index(cyc.ms, z.device),
                             y[..., _cycle_index(cyc.ns, z.device)])
    return z


def convdk_2d_strip(kernel: torch.Tensor, ia_strip: torch.Tensor,
                    sched: ConvDKSchedule) -> torch.Tensor:
    """DWConv of one ``k_h x ia_len`` IA strip with a ``k_h x k_w`` kernel.

    Implements Eq. (7) for a fixed channel c and output row h:
        y_{n,a} = sum_j sum_i  K[j, i] * I[j, i + n*k_w + a]
    All blocks n are evaluated in parallel per shift a (single TM read),
    masked by e_n, scattered to output columns m.

    ia_strip : (k_h, sched.ia_len)
    kernel   : (k_h, k_w)
    returns  : (sched.out_len,)
    """
    k_h = kernel.shape[0]
    if tuple(kernel.shape) != (k_h, sched.k):
        raise ValueError(f"kernel shape {tuple(kernel.shape)} != "
                         f"({k_h}, {sched.k})")
    if tuple(ia_strip.shape) != (k_h, sched.ia_len):
        raise ValueError(f"ia_strip shape {tuple(ia_strip.shape)} != "
                         f"({k_h}, {sched.ia_len})")
    return _strip_outputs(kernel, ia_strip, sched)


# ---------------------------------------------------------------------------
# Full depthwise Conv2D via ConvDK strips (Algorithm 2 orchestration)
# ---------------------------------------------------------------------------

def _strip_starts(out_w: int, per_strip: int, s: int) -> List[Tuple[int, int]]:
    """Static width-tiling: each strip produces ``per_strip`` output columns;
    consecutive strips overlap by the kernel halo.  Returns (out_start,
    in_start) pairs; the final strip is right-aligned so no partial strip is
    needed."""
    starts = []
    o = 0
    while o < out_w:
        o_eff = max(0, min(o, out_w - per_strip))  # right-align last strip
        starts.append((o_eff, o_eff * s))
        if o_eff + per_strip >= out_w:
            break
        o = o_eff + per_strip
    return starts


def _pads(h: int, w: int, k_h: int, k_w: int, s: int,
          padding: Union[str, int]):
    """(out_h, out_w, ((top, bottom), (left, right))) as
    ``repro.core.convdk`` pads: SAME puts the odd pad bottom/right."""
    if padding == "SAME":
        out_h, out_w = -(-h // s), -(-w // s)
        pad_h = max(0, (out_h - 1) * s + k_h - h)
        pad_w = max(0, (out_w - 1) * s + k_w - w)
        return out_h, out_w, ((pad_h // 2, pad_h - pad_h // 2),
                              (pad_w // 2, pad_w - pad_w // 2))
    if padding == "VALID":
        return (h - k_h) // s + 1, (w - k_w) // s + 1, ((0, 0), (0, 0))
    p = int(padding)
    return ((h + 2 * p - k_h) // s + 1, (w + 2 * p - k_w) // s + 1,
            ((p, p), (p, p)))


def dwconv2d_convdk(
    x: torch.Tensor,
    kernels: torch.Tensor,
    stride: int = 1,
    padding: Union[str, int] = "SAME",
    t_w: Optional[int] = None,
    trf_len: int = 180,
) -> torch.Tensor:
    """Depthwise Conv2D computed with the ConvDK dataflow (Algorithm 2).

    For every (channel, output row) a ``k_h x strip`` IA slice is "loaded
    into the TRF" and consumed through the ConvDK shift schedule; width
    larger than the TRF capacity is tiled into overlapping strips (the BIG
    scheduler's partitioning).  Every (channel, row, strip) runs at once.

    x        : (C, H, W) single-image ifmap.
    kernels  : (C, k_h, k_w) one kernel per channel.
    stride   : s (same for both dims, as in the paper's models).
    padding  : "SAME", "VALID" or explicit symmetric int pad.
    t_w      : TRF strip-width cap; default ``trf_len // k_h`` (paper's T_w).
    Returns (C, out_h, out_w).
    """
    c, h, w = x.shape
    ck, k_h, k_w = kernels.shape
    if ck != c:
        raise ValueError(f"channel mismatch {ck} != {c}")
    s = stride
    out_h, out_w, ((top, bottom), (left, right)) = _pads(h, w, k_h, k_w, s,
                                                         padding)
    xp = F.pad(x, (left, right, top, bottom))
    wp = xp.shape[2]

    if t_w is None:
        t_w = trf_len // k_h
    n = duplication_number(k_w, s, wp, t_w)
    if n < 1:
        raise ValueError(f"strip too narrow: W={wp}, t_w={t_w}, k_w={k_w}, "
                         f"s={s}")
    sched = make_schedule(k_w, s, n)
    starts = _strip_starts(out_w, sched.out_len, s)

    # the final (right-aligned) strip may read past the padded width
    need = max(i0 for _, i0 in starts) + sched.ia_len
    if need > wp:
        xp = F.pad(xp, (0, need - wp))
    # the k_h input rows of every output row: (C, out_h, k_h, W)
    rows = torch.arange(out_h, device=x.device)[:, None] * s \
        + torch.arange(k_h, device=x.device)[None, :]
    windows = xp[:, rows]
    kc = kernels[:, None]                        # (C, 1, k_h, k_w)
    out = x.new_zeros((c, out_h, out_w),
                      dtype=torch.promote_types(x.dtype, kernels.dtype))
    for o0, i0 in starts:                        # later strips overwrite
        z = _strip_outputs(kc, windows[..., i0:i0 + sched.ia_len], sched)
        take = min(sched.out_len, out_w - o0)
        out = torch.cat([out[..., :o0], z[..., :take],
                         out[..., o0 + take:]], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Oracle
# ---------------------------------------------------------------------------

def dwconv2d_oracle(x: torch.Tensor, kernels: torch.Tensor, stride: int = 1,
                    padding: Union[str, int] = "SAME") -> torch.Tensor:
    """Reference depthwise Conv2D, ``F.conv2d(groups=C)`` (CHW single
    image), padded as ``dwconv2d_convdk``."""
    c, h, w = x.shape
    _, k_h, k_w = kernels.shape
    _, _, ((top, bottom), (left, right)) = _pads(h, w, k_h, k_w, stride,
                                                 padding)
    xp = F.pad(x, (left, right, top, bottom))
    return F.conv2d(xp[None], kernels[:, None], stride=stride, groups=c)[0]
