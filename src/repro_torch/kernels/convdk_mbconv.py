"""Two-pass fused MBConv (EfficientNet) through hand-written CUDA kernels.

Counterpart of ``repro.kernels.convdk_mbconv``:

    expand 1x1 -> act -> DW k x k / s -> act -> SE (pool -> MLP -> gate)
    -> project 1x1

* **Pass 1** (``mbconv_pass1``): expand + DW per output tile; per-tile SE
  pool partial sums and the pool, their sum in tile order taken by the
  last CTA of each (image, c_mid tile) (so the pool repeats bit for bit),
  and under ``mode="retain"`` the DW tensor.
* **SE MLP** between the passes, in PyTorch: two tiny FCs on (B, C_mid).
* **Pass 2** folds the SE gate into the projection, reading the DW tensor
  back (``mbconv_pass2_retain``, a GEMM over the flattened pixels) or
  recomputing expand + DW from the input (``mbconv_pass2_recompute``);
  each splits C_mid over the grid where the card would be short of CTAs.
* **Split-K reduce** (``mbconv_splitk_reduce``): sums either pass 2's
  per-split partials in split order, so pass 2 repeats bit for bit.

Each pass wrapper launches its kernel (``kernels/csrc/mbconv.cu``) for
CUDA tensors and runs its plain PyTorch version for CPU tensors; any
other device raises.  ``LAUNCHES`` counts kernel launches per wrapper.

Pass 1 and recompute tile the output in ``tile_h x tile_w`` pixels;
recompute takes its c_out tile and split count from ``core.autotune.
recompute_plan``, retain its GEMM tile and split count from
``retain_plan``.  SAME padding, ragged tiles and ragged channel tiles are
masked inside the kernels, so the wrappers pad nothing.

``convdk_mbconv_fused`` is differentiable: when an operand requires grad
it goes through an autograd Function whose forward is the two passes above
and whose backward is autograd through ``mbconv_ref``, as the JAX
package's ``custom_vjp`` backward is ``jax.vjp`` of its oracle (the
kernels have no backward of their own, nor had the Pallas ones).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..core.autotune import (
    MAX_TILE_PIXELS,
    P1_CI_CHUNK,
    P1_MAX_TILE_PIXELS,
    RECOMPUTE_K_CHUNK,
    RETAIN_K_CHUNK,
    pass1_cm_tile,
    pass1_smem_bytes,
    recompute_co_tile,
    recompute_plan,
    recompute_smem_bytes,
    retain_plan,
)
from ..core.perfmodel import MBCONV_MODES
from . import _build
from .common import (
    ACT_CODES,
    FP32,
    check_cuda,
    needs_grad,
    on_cpu,
    ptr,
    spatial_pads,
    vjp_through,
)
from .ref import _act_ref, depthwise_valid, mbconv_ref, pad_nhwc

KERNELS: Tuple[str, ...] = ("mbconv_pass1", "mbconv_pass2_recompute",
                            "mbconv_pass2_retain", "mbconv_splitk_reduce")
# kernel launches per wrapper (reset with ``reset_launches``)
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "mbconv_pass1": [_P] * 7 + [_I] * 16 + [_P],
    "mbconv_pass2_recompute": [_P] * 6 + [_I] * 19 + [_P],
    "mbconv_pass2_retain": [_P] * 4 + [_I] * 7 + [_P],
    "mbconv_splitk_reduce": [_P, _P, _I, _L, _P],
}
# (k, s, tile_h, tile_w, c_in, c_mid) at which _lib() holds the built
# pass-1 shared-memory formula against core.autotune's, and with a c_out
# (k, s, tile_h, tile_w, c_in, c_mid, c_out) the recompute one
_SMEM_PROBES = ((3, 1, 8, 8, 16, 32), (5, 2, 7, 4, 112, 672),
                (5, 1, 12, 8, 192, 1152), (3, 2, 4, 8, 16, 96),
                (5, 2, 4, 4, 24, 144))
_R2_SMEM_PROBES = ((3, 1, 8, 8, 32, 32, 16), (3, 1, 8, 8, 24, 144, 24),
                   (5, 2, 8, 7, 24, 144, 40), (5, 1, 7, 7, 192, 1152, 320),
                   (3, 2, 8, 8, 16, 64, 24), (3, 2, 4, 16, 40, 240, 80))
# SE pool arrival counters: one int per (image, pass-1 c_mid tile) of a
# launch, in one zeroed buffer per device that every launch leaves zeroed
POOL_COUNTERS = 1 << 16
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mbconv")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.mbconv_error_string.argtypes = [ctypes.c_int]
    lib.mbconv_error_string.restype = ctypes.c_char_p
    lib.mbconv_pass1_smem_bytes.argtypes = [_I] * 7
    lib.mbconv_pass1_smem_bytes.restype = ctypes.c_longlong
    lib.mbconv_recompute_smem_bytes.argtypes = [_I] * 8
    lib.mbconv_recompute_smem_bytes.restype = ctypes.c_longlong
    built = (lib.mbconv_max_tile_pixels(), lib.mbconv_recompute_k_chunk(),
             lib.mbconv_pass1_ci_chunk(), lib.mbconv_pass1_max_tile_pixels(),
             lib.mbconv_retain_k_chunk(), lib.mbconv_pass1_cm_tile(40),
             lib.mbconv_pass1_cm_tile(96),
             *(lib.mbconv_pass1_smem_bytes(*p, 0) for p in _SMEM_PROBES),
             *(lib.mbconv_recompute_smem_bytes(*p[:-1], recompute_co_tile(
                 p[-1]), 0) for p in _R2_SMEM_PROBES))
    want = (MAX_TILE_PIXELS, RECOMPUTE_K_CHUNK, P1_CI_CHUNK,
            P1_MAX_TILE_PIXELS, RETAIN_K_CHUNK, pass1_cm_tile(40),
            pass1_cm_tile(96),
            *(pass1_smem_bytes(*p) for p in _SMEM_PROBES),
            *(recompute_smem_bytes(*p) for p in _R2_SMEM_PROBES))
    if built != want:
        raise RuntimeError(f"mbconv.cu constants {built} disagree with "
                           f"core.autotune {want}")
    return lib


def _launch(name: str, *args) -> None:
    lib = _lib()
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} did not launch: "
                           f"{lib.mbconv_error_string(err).decode()}")
    LAUNCHES[name] += 1


def _pool_counters(device: torch.device, needed: int) -> torch.Tensor:
    """The device's zeroed SE pool counters, allocated (outside any CUDA
    graph capture) at its first pass-1 launch with SE."""
    if needed > POOL_COUNTERS:
        raise ValueError(f"pass 1 needs {needed} pool counters (batch x "
                         f"c_mid tiles), more than the {POOL_COUNTERS} "
                         f"allocated")
    buf = _COUNTERS.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the SE pool counters are allocated at the "
                               "first eager pass-1 launch on a device: run "
                               "one before capturing a CUDA graph")
        buf = torch.zeros(POOL_COUNTERS, dtype=torch.int32, device=device)
        torch.cuda.current_stream(device).synchronize()
        _COUNTERS[device] = buf
    return buf


@dataclass(frozen=True)
class MBConvGeometry:
    """Spatial geometry of one MBConv launch: the input dims, the conv's
    output dims and SAME pads ((top, bottom), (left, right)), and the
    output tiling (clamped to the output)."""

    h: int
    w: int
    k: int
    s: int
    out_h: int
    out_w: int
    pads: Tuple[Tuple[int, int], Tuple[int, int]]
    tile_h: int
    tile_w: int

    @classmethod
    def make(cls, h: int, w: int, k: int, s: int, padding: str,
             tile_h: int, tile_w: int) -> "MBConvGeometry":
        out_h, out_w, pads = spatial_pads(h, w, k, k, s, padding)
        return cls(h, w, k, s, out_h, out_w, pads,
                   max(1, min(tile_h, out_h)), max(1, min(tile_w, out_w)))

    @property
    def n_th(self) -> int:
        return -(-self.out_h // self.tile_h)

    @property
    def n_tw(self) -> int:
        return -(-self.out_w // self.tile_w)

    @property
    def n_tiles(self) -> int:
        return self.n_th * self.n_tw


def _check_shapes(x, w_exp, w_dw, geo: MBConvGeometry) -> None:
    b, h, w, c_in = x.shape
    k_h, k_w, c_mid = w_dw.shape
    if (h, w) != (geo.h, geo.w) or (k_h, k_w) != (geo.k, geo.k):
        raise ValueError(f"x {tuple(x.shape)} / w_dw {tuple(w_dw.shape)} "
                         f"do not match {geo}")
    if w_exp is None:
        if c_in != c_mid:
            raise ValueError("identity expand needs C_in == C_mid")
    elif tuple(w_exp.shape) != (c_in, c_mid):
        raise ValueError(f"w_exp {tuple(w_exp.shape)} != {(c_in, c_mid)}")
    if not on_cpu(x) and c_in % 4:
        raise ValueError(f"the kernels take C_in % 4 == 0, got {c_in}")


# ---------------------------------------------------------------------------
# per-pass wrappers, each beside its plain version (the CPU path, and the
# kernel's oracle on the card)
# ---------------------------------------------------------------------------

def _expand_dw_plain(x, w_exp, w_dw, geo: MBConvGeometry, exp_act, dw_act):
    """Zero-pad x (as the JAX kernel does), expand, act, DW, act."""
    xp = pad_nhwc(x, geo.pads)
    e = _act_ref(xp if w_exp is None else xp @ w_exp, exp_act)
    return _act_ref(depthwise_valid(e, w_dw, geo.s), dw_act)


def _gated(d: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    return d if gate is None else d * gate[:, None, None, :]


def mbconv_pass1_plain(x, w_exp, w_dw, geo: MBConvGeometry, *, exp_act,
                       dw_act, se=True, retain=False):
    """Plain version of ``mbconv_pass1``."""
    d = _expand_dw_plain(x, w_exp, w_dw, geo, exp_act, dw_act)
    partial = pool = None
    if se:
        # per-tile sums, tile-major in (row tile, column tile) order
        b, _, _, c = d.shape
        dp = torch.nn.functional.pad(
            d, (0, 0, 0, geo.n_tw * geo.tile_w - geo.out_w,
                0, geo.n_th * geo.tile_h - geo.out_h))
        partial = dp.reshape(b, geo.n_th, geo.tile_h, geo.n_tw, geo.tile_w,
                             c).sum(dim=(2, 4)).reshape(b, geo.n_tiles, c)
        pool = mbconv_pool_reduce_plain(partial)
    return partial, pool, (d if retain else None)


def mbconv_pass1(x: torch.Tensor, w_exp: Optional[torch.Tensor],
                 w_dw: torch.Tensor, geo: MBConvGeometry, *,
                 exp_act: Optional[str], dw_act: Optional[str],
                 se: bool = True, retain: bool = False
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                            Optional[torch.Tensor]]:
    """Pass 1: (SE pool partials (B, n_tiles, C_mid), the pool (B, C_mid):
    the partials summed in tile order; both None without SE, and the DW
    tensor (B, out_h, out_w, C_mid) or None).  ``w_exp=None`` is the
    identity expand of expansion-ratio-1 blocks."""
    if not (se or retain):
        raise ValueError("se=off + recompute has no pass 1")
    _check_shapes(x, w_exp, w_dw, geo)
    if on_cpu(x):
        return mbconv_pass1_plain(x, w_exp, w_dw, geo, exp_act=exp_act,
                                  dw_act=dw_act, se=se, retain=retain)
    check_cuda(x, w_exp, w_dw, dtypes=FP32)
    b, h, w, c_in = x.shape
    c_mid = w_dw.shape[-1]
    partial = pool = counters = None
    if se:
        partial = torch.empty((b, geo.n_tiles, c_mid), device=x.device)
        pool = torch.empty((b, c_mid), device=x.device)
        counters = _pool_counters(x.device,
                                  b * -(-c_mid // pass1_cm_tile(c_mid)))
    dw = (torch.empty((b, geo.out_h, geo.out_w, c_mid), device=x.device)
          if retain else None)
    _launch("mbconv_pass1", ptr(x), ptr(w_exp), ptr(w_dw), ptr(partial),
            ptr(pool), ptr(counters), ptr(dw), b, h, w, c_in, c_mid, geo.k,
            geo.s, geo.out_h, geo.out_w, geo.pads[0][0], geo.pads[1][0],
            geo.tile_h, geo.tile_w, int(w_exp is None), ACT_CODES[exp_act],
            ACT_CODES[dw_act])
    return partial, pool, dw


def mbconv_pool_reduce_plain(partial: torch.Tensor) -> torch.Tensor:
    """(B, n_tiles, C) per-tile partials -> (B, C) sums, in tile order: the
    plain version of pass 1's pool."""
    acc = torch.zeros_like(partial[:, 0])
    for t in range(partial.shape[1]):
        acc = acc + partial[:, t]
    return acc


def mbconv_pass2_recompute_plain(x, w_exp, w_dw, gate, w_proj,
                                 geo: MBConvGeometry, *, exp_act, dw_act):
    """Plain version of ``mbconv_pass2_recompute``."""
    d = _expand_dw_plain(x, w_exp, w_dw, geo, exp_act, dw_act)
    return _gated(d, gate) @ w_proj


def mbconv_pass2_recompute_partials_plain(x, w_exp, w_dw, gate, w_proj,
                                          geo: MBConvGeometry, splits: int,
                                          *, exp_act, dw_act):
    """Plain version of a split recompute launch's partials (splits, B,
    out_h, out_w, C_out): split z projects pass 1's c_mid chunks
    [z * per, (z + 1) * per), per = ceil(chunks / splits)."""
    d = _gated(_expand_dw_plain(x, w_exp, w_dw, geo, exp_act, dw_act), gate)
    c_mid = w_proj.shape[0]
    cmt = pass1_cm_tile(c_mid)
    chunks = -(-c_mid // cmt)
    per = -(-chunks // splits) * cmt
    return torch.stack([d[..., z * per:(z + 1) * per]
                        @ w_proj[z * per:(z + 1) * per]
                        for z in range(splits)])


def mbconv_pass2_recompute(x: torch.Tensor, w_exp: Optional[torch.Tensor],
                           w_dw: torch.Tensor, gate: Optional[torch.Tensor],
                           w_proj: torch.Tensor, geo: MBConvGeometry, *,
                           exp_act: Optional[str], dw_act: Optional[str]
                           ) -> torch.Tensor:
    """Pass 2, recompute: expand + DW again, x gate (``None`` = se off),
    projection -> (B, out_h, out_w, C_out).  The c_out tile and C_mid
    splits come from ``recompute_plan``; a split launch ends in
    ``mbconv_splitk_reduce``."""
    _check_shapes(x, w_exp, w_dw, geo)
    if on_cpu(x):
        return mbconv_pass2_recompute_plain(x, w_exp, w_dw, gate, w_proj,
                                            geo, exp_act=exp_act,
                                            dw_act=dw_act)
    check_cuda(x, w_exp, w_dw, gate, w_proj, dtypes=FP32)
    if geo.tile_h * geo.tile_w > MAX_TILE_PIXELS:
        raise ValueError(f"the recompute kernel takes tiles of at most "
                         f"{MAX_TILE_PIXELS} pixels, got {geo}")
    b, h, w, c_in = x.shape
    c_mid, c_out = w_proj.shape
    co_tile, splits = recompute_plan(b, geo.out_h, geo.out_w, c_mid, c_out,
                                     geo.tile_h, geo.tile_w)
    out = torch.empty((splits, b, geo.out_h, geo.out_w, c_out),
                      device=x.device)
    _launch("mbconv_pass2_recompute", ptr(x), ptr(w_exp), ptr(w_dw),
            ptr(gate), ptr(w_proj), ptr(out), b, h, w, c_in, c_mid, c_out,
            geo.k, geo.s, geo.out_h, geo.out_w, geo.pads[0][0],
            geo.pads[1][0], geo.tile_h, geo.tile_w, int(w_exp is None),
            ACT_CODES[exp_act], ACT_CODES[dw_act], co_tile, splits)
    return out[0] if splits == 1 else mbconv_splitk_reduce(out)


def mbconv_pass2_retain_plain(dw, gate, w_proj, geo: MBConvGeometry):
    """Plain version of ``mbconv_pass2_retain``."""
    return _gated(dw, gate) @ w_proj


def mbconv_pass2_retain(dw: torch.Tensor, gate: Optional[torch.Tensor],
                        w_proj: torch.Tensor, geo: MBConvGeometry
                        ) -> torch.Tensor:
    """Pass 2, retain: the DW tensor x gate (``None`` = se off),
    projection -> (B, out_h, out_w, C_out).  ``geo`` is checked against
    ``dw``'s shape only: the GEMM's tile and K splits come from
    ``retain_plan``, and a split launch ends in ``mbconv_splitk_reduce``."""
    b, out_h, out_w, c_mid = dw.shape
    if (out_h, out_w) != (geo.out_h, geo.out_w):
        raise ValueError(f"dw {tuple(dw.shape)} does not match {geo}")
    if on_cpu(dw):
        return mbconv_pass2_retain_plain(dw, gate, w_proj, geo)
    check_cuda(dw, gate, w_proj, dtypes=FP32)
    c_out = w_proj.shape[1]
    m = b * out_h * out_w
    bm, bn, splits = retain_plan(m, c_mid, c_out)
    out = torch.empty((splits, b, out_h, out_w, c_out), device=dw.device)
    _launch("mbconv_pass2_retain", ptr(dw), ptr(gate), ptr(w_proj),
            ptr(out), m, c_mid, c_out, out_h * out_w, bm, bn, splits)
    return out[0] if splits == 1 else mbconv_splitk_reduce(out)


def mbconv_splitk_reduce_plain(partial: torch.Tensor) -> torch.Tensor:
    """Plain version of ``mbconv_splitk_reduce``, in the kernel's order."""
    acc = partial[0].clone()
    for z in range(1, partial.shape[0]):
        acc = acc + partial[z]
    return acc


def mbconv_splitk_reduce(partial: torch.Tensor) -> torch.Tensor:
    """(splits, ...) per-split partial products -> their sum, taken in
    split order."""
    if on_cpu(partial):
        return mbconv_splitk_reduce_plain(partial)
    check_cuda(partial, dtypes=FP32)
    out = torch.empty(partial.shape[1:], device=partial.device)
    _launch("mbconv_splitk_reduce", ptr(partial), ptr(out), partial.shape[0],
            out.numel())
    return out


# ---------------------------------------------------------------------------
# host glue
# ---------------------------------------------------------------------------

def _mbconv_impl(x, w_exp, w_dw, w_se1, b_se1, w_se2, b_se2, w_proj, *,
                 stride, padding, tile_h, tile_w, mode, exp_act, dw_act,
                 se_act, gate_act):
    """Two-pass fused MBConv on one device.

    ``w_se1 is None`` switches SE off: no pool, no MLP, no gate — and
    under ``mode="recompute"`` pass 1 is skipped entirely.
    """
    if mode not in MBCONV_MODES:
        raise ValueError(mode)
    k_h, k_w, _ = w_dw.shape
    if k_h != k_w:
        raise ValueError(f"square DW kernels only, got {k_h}x{k_w}")
    geo = MBConvGeometry.make(x.shape[1], x.shape[2], k_h, stride, padding,
                              tile_h, tile_w)
    se = w_se1 is not None
    pool, dw = None, None
    if se or mode == "retain":
        _, pool, dw = mbconv_pass1(x, w_exp, w_dw, geo, exp_act=exp_act,
                                   dw_act=dw_act, se=se,
                                   retain=mode == "retain")
    gate = None
    if se:
        # SE MLP on the pool (the mean divides by the true out_h * out_w)
        mean = pool / float(geo.out_h * geo.out_w)
        s1 = _act_ref(mean @ w_se1 + b_se1, se_act)
        gate = _act_ref(s1 @ w_se2 + b_se2, gate_act).contiguous()
    if mode == "retain":
        return mbconv_pass2_retain(dw, gate, w_proj, geo)
    return mbconv_pass2_recompute(x, w_exp, w_dw, gate, w_proj, geo,
                                  exp_act=exp_act, dw_act=dw_act)


class _MBConvFn(torch.autograd.Function):
    """``_mbconv_impl`` forward; backward through ``mbconv_ref``."""

    @staticmethod
    def forward(ctx, x, w_exp, w_dw, w_se1, b_se1, w_se2, b_se2, w_proj,
                conf):
        ctx.save_for_backward(x, w_exp, w_dw, w_se1, b_se1, w_se2, b_se2,
                              w_proj)
        ctx.conf = conf
        return _mbconv_impl(x, w_exp, w_dw, w_se1, b_se1, w_se2, b_se2,
                            w_proj, **conf)

    @staticmethod
    def backward(ctx, grad_out):
        c = ctx.conf

        def ref(*args):
            return mbconv_ref(*args, stride=c["stride"],
                              padding=c["padding"], exp_act=c["exp_act"],
                              dw_act=c["dw_act"], se_act=c["se_act"],
                              gate_act=c["gate_act"])

        return (*vjp_through(ref, ctx.saved_tensors, grad_out,
                             ctx.needs_input_grad[:8]), None)


def convdk_mbconv_fused(
    x: torch.Tensor,
    w_exp: Optional[torch.Tensor],
    w_dw: torch.Tensor,
    w_se1: Optional[torch.Tensor],
    b_se1: Optional[torch.Tensor],
    w_se2: Optional[torch.Tensor],
    b_se2: Optional[torch.Tensor],
    w_proj: torch.Tensor,
    *,
    stride: int = 1,
    padding: str = "SAME",
    tile_h: int = 8,
    tile_w: int = 8,
    mode: str = "retain",
    exp_act: Optional[str] = "silu",
    dw_act: Optional[str] = "silu",
    se_act: Optional[str] = "silu",
    gate_act: Optional[str] = "sigmoid",
) -> torch.Tensor:
    """Two-pass fused MBConv block, no residual add (the model layer owns
    it).  Layouts as ``repro.kernels.convdk_mbconv_fused``:

    x      : (B, H, W, C_in) NHWC
    w_exp  : (C_in, C_mid); ``None`` is the identity expand of expansion
             ratio 1 (pass ``exp_act=None`` with it, as the JAX model does
             with an explicit identity matrix)
    w_dw   : (k, k, C_mid)
    w_se1/b_se1, w_se2/b_se2 : SE FCs, all four ``None`` for a no-SE block
    w_proj : (C_mid, C_out)
    mode   : "retain" | "recompute" (``core.autotune`` picks per layer)
    Returns (B, H', W', C_out).
    """
    args = (x, w_exp, w_dw, w_se1, b_se1, w_se2, b_se2, w_proj)
    conf = dict(stride=stride, padding=padding, tile_h=tile_h,
                tile_w=tile_w, mode=mode, exp_act=exp_act, dw_act=dw_act,
                se_act=se_act, gate_act=gate_act)
    if needs_grad(*args):
        return _MBConvFn.apply(*args, conf)
    return _mbconv_impl(*args, **conf)
