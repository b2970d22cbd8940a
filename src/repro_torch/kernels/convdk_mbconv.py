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
  A split launch writes fp32 per-split partials, and the last CTA of each
  output tile sums them in split order (the split-K sum, folded into the
  kernel), so pass 2 repeats bit for bit in one launch.
  ``mbconv_pass2_retain_with_partials`` and
  ``mbconv_pass2_recompute_with_partials`` also return those partials.

Each pass wrapper launches its kernel (``kernels/csrc/mbconv.cu``) for
CUDA tensors and runs its plain PyTorch version for CPU tensors (for a
split pass 2, the plain partials summed in the kernel's order, so the
two agree bit for bit); any other device raises.  ``LAUNCHES`` counts kernel launches per wrapper.

The activations and weights take one storage type, fp32 or bf16
(``common.STORAGE``; a CUDA tensor launches the build of its type, any
other type raises); every sum is fp32, the SE pool, its partials, the gate
and the split partials are fp32, and the retained DW tensor and each
pass's output round once to the storage type, as the JAX kernels do.  The
plain versions compute in fp32 from the storage-type operands and round
at the same points (recompute never rounds its DW tile).

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
    RETAIN_TILES,
    pass1_cm_tile,
    pass1_smem_bytes,
    recompute_co_tile,
    recompute_plan,
    recompute_smem_bytes,
    retain_plan,
    retain_smem_bytes,
)
from ..core.perfmodel import MBCONV_MODES
from . import _build
from .common import (
    ACT_CODES,
    FP32,
    STORAGE,
    arrival_counters,
    check_cuda,
    launch_name,
    needs_grad,
    on_cpu,
    ptr,
    reduce_partial,
    spatial_pads,
    storage_dtype,
    vjp_through,
)
from .ref import _act_ref, depthwise_valid, mbconv_ref, pad_nhwc

FP32_KERNELS: Tuple[str, ...] = (
    "mbconv_pass1", "mbconv_pass2_recompute", "mbconv_pass2_retain")
# every kernel build: the fp32 kernels, then their bf16 builds
KERNELS: Tuple[str, ...] = FP32_KERNELS + tuple(
    launch_name(k, torch.bfloat16) for k in FP32_KERNELS)
# kernel launches per wrapper and storage type (reset with
# ``reset_launches``)
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mbconv_pass1": [_P] * 7 + [_I] * 16 + [_P],
    "mbconv_pass2_recompute": [_P] * 8 + [_I] * 19 + [_P],
    "mbconv_pass2_retain": [_P] * 6 + [_I] * 7 + [_P],
}
# the library of each storage type (kernels/_build.py's VARIANTS)
_LIBRARIES = {torch.float32: "mbconv", torch.bfloat16: "mbconv_bf16"}
# (k, s, tile_h, tile_w, c_in, c_mid) at which _lib() holds the built
# pass-1 shared-memory formula against core.autotune's, and with a c_out
# (k, s, tile_h, tile_w, c_in, c_mid, c_out) the recompute one
_SMEM_PROBES = ((3, 1, 8, 8, 16, 32), (5, 2, 7, 4, 112, 672),
                (5, 1, 12, 8, 192, 1152), (3, 2, 4, 8, 16, 96),
                (5, 2, 4, 4, 24, 144))
_R2_SMEM_PROBES = ((3, 1, 8, 8, 32, 32, 16), (3, 1, 8, 8, 24, 144, 24),
                   (5, 2, 8, 7, 24, 144, 40), (5, 1, 7, 7, 192, 1152, 320),
                   (3, 2, 8, 8, 16, 64, 24), (3, 2, 4, 16, 40, 240, 80))

def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib(dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    """The bound build of mbconv.cu for the storage type ``dtype``, its
    constants and shared-memory formulas held against core.autotune's."""
    lib = _build.load(_LIBRARIES[dtype])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.mbconv_error_string.argtypes = [ctypes.c_int]
    lib.mbconv_error_string.restype = ctypes.c_char_p
    lib.mbconv_pass1_smem_bytes.argtypes = [_I] * 7
    lib.mbconv_pass1_smem_bytes.restype = ctypes.c_longlong
    lib.mbconv_recompute_smem_bytes.argtypes = [_I] * 8
    lib.mbconv_recompute_smem_bytes.restype = ctypes.c_longlong
    lib.mbconv_retain_smem_bytes.argtypes = [_I] * 2
    lib.mbconv_retain_smem_bytes.restype = ctypes.c_longlong
    eb = dtype.itemsize
    built = (lib.mbconv_element_bytes(), lib.mbconv_max_tile_pixels(),
             lib.mbconv_recompute_k_chunk(), lib.mbconv_pass1_ci_chunk(),
             lib.mbconv_pass1_max_tile_pixels(), lib.mbconv_retain_k_chunk(),
             lib.mbconv_pass1_cm_tile(40), lib.mbconv_pass1_cm_tile(96),
             *(lib.mbconv_pass1_smem_bytes(*p, 0) for p in _SMEM_PROBES),
             *(lib.mbconv_recompute_smem_bytes(*p[:-1], recompute_co_tile(
                 p[-1]), 0) for p in _R2_SMEM_PROBES),
             *(lib.mbconv_retain_smem_bytes(*t) for t in RETAIN_TILES))
    want = (eb, MAX_TILE_PIXELS, RECOMPUTE_K_CHUNK, P1_CI_CHUNK,
            P1_MAX_TILE_PIXELS, RETAIN_K_CHUNK, pass1_cm_tile(40),
            pass1_cm_tile(96),
            *(pass1_smem_bytes(*p, eb=eb) for p in _SMEM_PROBES),
            *(recompute_smem_bytes(*p, eb=eb) for p in _R2_SMEM_PROBES),
            *(retain_smem_bytes(*t, eb=eb) for t in RETAIN_TILES))
    if built != want:
        raise RuntimeError(f"mbconv.cu ({_LIBRARIES[dtype]}) constants "
                           f"{built} disagree with core.autotune {want}")
    return lib


def _launch(name: str, dtype: torch.dtype, *args) -> None:
    lib = _lib(dtype)
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} ({dtype}) did not launch: "
                           f"{lib.mbconv_error_string(err).decode()}")
    LAUNCHES[launch_name(name, dtype)] += 1


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
    """Zero-pad x (as the JAX kernel does), expand, act, DW, act: in fp32
    from the storage-type operands."""
    xp = pad_nhwc(x.float(), geo.pads)
    e = _act_ref(xp if w_exp is None else xp @ w_exp.float(), exp_act)
    return _act_ref(depthwise_valid(e, w_dw.float(), geo.s), dw_act)


def _gated(d: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    return d if gate is None else d * gate[:, None, None, :]


def mbconv_pass1_plain(x, w_exp, w_dw, geo: MBConvGeometry, *, exp_act,
                       dw_act, se=True, retain=False):
    """Plain version of ``mbconv_pass1``: fp32 pool sums of the fp32 DW
    tile, the DW tensor rounded once to x's dtype."""
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
    return partial, pool, (d.to(x.dtype) if retain else None)


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
    dtype = storage_dtype(x, w_exp, w_dw)
    if on_cpu(x):
        return mbconv_pass1_plain(x, w_exp, w_dw, geo, exp_act=exp_act,
                                  dw_act=dw_act, se=se, retain=retain)
    check_cuda(x, w_exp, w_dw, dtypes=STORAGE)
    b, h, w, c_in = x.shape
    c_mid = w_dw.shape[-1]
    partial = pool = counters = None
    if se:
        partial = torch.empty((b, geo.n_tiles, c_mid), device=x.device)
        pool = torch.empty((b, c_mid), device=x.device)
        counters = arrival_counters(
            x.device, b * -(-c_mid // pass1_cm_tile(c_mid)), "mbconv_pass1")
    dw = (torch.empty((b, geo.out_h, geo.out_w, c_mid), device=x.device,
                      dtype=dtype) if retain else None)
    _launch("mbconv_pass1", dtype, ptr(x), ptr(w_exp), ptr(w_dw), ptr(partial),
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
    """Plain version of ``mbconv_pass2_recompute``: fp32 throughout (the
    DW tile never rounded), the output rounded once to x's dtype."""
    d = _expand_dw_plain(x, w_exp, w_dw, geo, exp_act, dw_act)
    return (_gated(d, gate) @ w_proj.float()).to(x.dtype)


def mbconv_pass2_recompute_partials_plain(x, w_exp, w_dw, gate, w_proj,
                                          geo: MBConvGeometry, splits: int,
                                          *, exp_act, dw_act):
    """Plain version of a split recompute launch's partials (splits, B,
    out_h, out_w, C_out), fp32: split z projects pass 1's c_mid chunks
    [z * per, (z + 1) * per), per = ceil(chunks / splits)."""
    d = _gated(_expand_dw_plain(x, w_exp, w_dw, geo, exp_act, dw_act), gate)
    w_proj = w_proj.float()
    c_mid = w_proj.shape[0]
    cmt = pass1_cm_tile(c_mid)
    chunks = -(-c_mid // cmt)
    per = -(-chunks // splits) * cmt
    return torch.stack([d[..., z * per:(z + 1) * per]
                        @ w_proj[z * per:(z + 1) * per]
                        for z in range(splits)])


def mbconv_pass2_recompute_with_partials(
        x: torch.Tensor, w_exp: Optional[torch.Tensor], w_dw: torch.Tensor,
        gate: Optional[torch.Tensor], w_proj: torch.Tensor,
        geo: MBConvGeometry, *, exp_act: Optional[str],
        dw_act: Optional[str]
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``mbconv_pass2_recompute`` with its launch's fp32 split partials:
    (the output, the partials (splits, B, out_h, out_w, C_out), or None
    where ``recompute_plan`` does not split C_mid).  On the card one
    launch writes both, its last CTA per output tile summing the partials
    in split order; on the CPU the plain partials and their split-order
    sum (``mbconv_splitk_reduce_plain``)."""
    _check_shapes(x, w_exp, w_dw, geo)
    dtype = storage_dtype(x, w_exp, w_dw, w_proj)
    b, h, w, c_in = x.shape
    c_mid, c_out = w_proj.shape
    co_tile, splits = recompute_plan(b, geo.out_h, geo.out_w, c_mid, c_out,
                                     geo.tile_h, geo.tile_w)
    acts = dict(exp_act=exp_act, dw_act=dw_act)
    if on_cpu(x):
        if splits == 1:
            return mbconv_pass2_recompute_plain(
                x, w_exp, w_dw, gate, w_proj, geo, **acts), None
        part = mbconv_pass2_recompute_partials_plain(
            x, w_exp, w_dw, gate, w_proj, geo, splits, **acts)
        return mbconv_splitk_reduce_plain(part, dtype), part
    check_cuda(x, w_exp, w_dw, w_proj, dtypes=STORAGE)
    check_cuda(gate, dtypes=FP32)
    if geo.tile_h * geo.tile_w > MAX_TILE_PIXELS:
        raise ValueError(f"the recompute kernel takes tiles of at most "
                         f"{MAX_TILE_PIXELS} pixels, got {geo}")
    out, part, counters = _pass2_outputs(
        splits, (b, geo.out_h, geo.out_w, c_out), dtype, x.device,
        geo.n_tiles * -(-c_out // co_tile) * b, "mbconv_pass2_recompute")
    _launch("mbconv_pass2_recompute", dtype, ptr(x), ptr(w_exp), ptr(w_dw),
            ptr(gate), ptr(w_proj), ptr(part), ptr(counters), ptr(out), b, h,
            w, c_in, c_mid, c_out, geo.k, geo.s, geo.out_h, geo.out_w,
            geo.pads[0][0], geo.pads[1][0], geo.tile_h, geo.tile_w,
            int(w_exp is None), ACT_CODES[exp_act], ACT_CODES[dw_act],
            co_tile, splits)
    return out, part


def mbconv_pass2_recompute(x: torch.Tensor, w_exp: Optional[torch.Tensor],
                           w_dw: torch.Tensor, gate: Optional[torch.Tensor],
                           w_proj: torch.Tensor, geo: MBConvGeometry, *,
                           exp_act: Optional[str], dw_act: Optional[str]
                           ) -> torch.Tensor:
    """Pass 2, recompute: expand + DW again, x gate (``None`` = se off),
    projection -> (B, out_h, out_w, C_out), in one launch.  The c_out tile
    and C_mid splits come from ``recompute_plan``; a split launch sums its
    partials in its last CTAs."""
    return mbconv_pass2_recompute_with_partials(
        x, w_exp, w_dw, gate, w_proj, geo, exp_act=exp_act,
        dw_act=dw_act)[0]


def _pass2_outputs(splits: int, shape, dtype: torch.dtype,
                   device: torch.device, tiles: int, kernel: str):
    """(the output in the storage type, fp32 split partials or None, the
    arrival counters or None) of a pass-2 launch of ``tiles`` output
    tiles: a split launch also writes its partials, summed by its last
    CTA per tile."""
    out = torch.empty(shape, device=device, dtype=dtype)
    if splits == 1:
        return out, None, None
    return (out, torch.empty((splits, *shape), device=device),
            arrival_counters(device, tiles, kernel))


def mbconv_pass2_retain_plain(dw, gate, w_proj, geo: MBConvGeometry):
    """Plain version of ``mbconv_pass2_retain``: fp32 from the
    storage-type DW tensor and weights, rounded once to dw's dtype."""
    return (_gated(dw.float(), gate) @ w_proj.float()).to(dw.dtype)


def mbconv_pass2_retain_partials_plain(dw, gate, w_proj,
                                       splits: int) -> torch.Tensor:
    """Plain version of a split retain launch's partials (splits, B,
    out_h, out_w, C_out), fp32: split z projects the C_mid rows of the
    GEMM's K chunks [z * per, (z + 1) * per), per = ceil(chunks /
    splits)."""
    d = _gated(dw.float(), gate)
    w_proj = w_proj.float()
    chunks = -(-w_proj.shape[0] // RETAIN_K_CHUNK)
    per = -(-chunks // splits) * RETAIN_K_CHUNK
    return torch.stack([d[..., z * per:(z + 1) * per]
                        @ w_proj[z * per:(z + 1) * per]
                        for z in range(splits)])


def mbconv_splitk_reduce_plain(partial: torch.Tensor,
                               dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """(splits, ...) fp32 per-split partial products -> their sum in split
    order, rounded once to ``dtype``: the plain version of the split-K sum
    that a split pass-2 launch's last CTAs take, in the kernels' order."""
    if dtype not in STORAGE:
        raise ValueError(f"the split-K sum writes one of {STORAGE}, got "
                         f"{dtype}")
    acc = partial[0].clone()
    for z in range(1, partial.shape[0]):
        acc = acc + partial[z]
    return acc.to(dtype)


def _check_dw(dw, w_proj, geo: MBConvGeometry) -> torch.dtype:
    """The storage type of a retain launch; raises where the DW tensor's
    map is not ``geo``'s output."""
    if tuple(dw.shape[1:3]) != (geo.out_h, geo.out_w):
        raise ValueError(f"dw {tuple(dw.shape)} does not match {geo}")
    return storage_dtype(dw, w_proj)


def mbconv_pass2_retain_with_partials(
        dw: torch.Tensor, gate: Optional[torch.Tensor], w_proj: torch.Tensor,
        geo: MBConvGeometry, max_splits: Optional[int] = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``mbconv_pass2_retain`` with its launch's fp32 split partials: (the
    output, the partials (splits, B, out_h, out_w, C_out), or None where
    ``retain_plan`` does not split K).  On the card one launch writes
    both, its last CTA per output tile summing the partials in split
    order; on the CPU the plain partials and their split-order sum."""
    dtype = _check_dw(dw, w_proj, geo)
    b, out_h, out_w, c_mid = dw.shape
    c_out = w_proj.shape[1]
    m = b * out_h * out_w
    bm, bn, splits = retain_plan(m, c_mid, c_out, max_splits,
                                 dtype.itemsize)
    if on_cpu(dw):
        if splits == 1:
            return mbconv_pass2_retain_plain(dw, gate, w_proj, geo), None
        part = mbconv_pass2_retain_partials_plain(dw, gate, w_proj, splits)
        return mbconv_splitk_reduce_plain(part, dtype), part
    check_cuda(dw, w_proj, dtypes=STORAGE)
    check_cuda(gate, dtypes=FP32)
    out, part, counters = _pass2_outputs(
        splits, (b, out_h, out_w, c_out), dtype, dw.device,
        -(-m // bm) * -(-c_out // bn), "mbconv_pass2_retain")
    _launch("mbconv_pass2_retain", dtype, ptr(dw), ptr(gate), ptr(w_proj),
            ptr(part), ptr(counters), ptr(out), m, c_mid, c_out,
            out_h * out_w, bm, bn, splits)
    return out, part


def mbconv_pass2_retain(dw: torch.Tensor, gate: Optional[torch.Tensor],
                        w_proj: torch.Tensor, geo: MBConvGeometry,
                        max_splits: Optional[int] = None) -> torch.Tensor:
    """Pass 2, retain: the DW tensor x gate (``None`` = se off),
    projection -> (B, out_h, out_w, C_out), in one launch.  ``geo`` is
    checked against ``dw``'s shape only: the GEMM's tile and K splits come
    from ``retain_plan`` (``max_splits`` caps the splits: the schedule's
    ``retain_splits``), and a split launch sums its partials in its last
    CTAs."""
    return mbconv_pass2_retain_with_partials(dw, gate, w_proj, geo,
                                             max_splits)[0]


# ---------------------------------------------------------------------------
# host glue
# ---------------------------------------------------------------------------

def _mbconv_impl(x, w_exp, w_dw, w_se1, b_se1, w_se2, b_se2, w_proj, *,
                 stride, padding, tile_h, tile_w, mode, exp_act, dw_act,
                 se_act, gate_act, retain_splits=None, mesh=None,
                 collective="ring_allreduce", scatter_width=0):
    """Two-pass fused MBConv on one device, or on one rank's slice of the
    c_mid grid when ``mesh`` is given (``kernels.convdk_sharded``).

    On a mesh the two contractions over the whole expanded width cross
    the "model" group: the SE squeeze ``mean @ w_se1`` is all-reduced
    before its bias and nonlinearity (the pool leaves the card once, as a
    (B, C_se) partial), and the projection partial is reduced per
    ``collective`` (``common.reduce_partial``: all-reduced, or
    reduce-scattered at ``scatter_width`` channels).

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
        # in fp32 at every storage type, as the JAX package's
        mean = pool / float(geo.out_h * geo.out_w)
        squeeze = mean @ w_se1.float()
        if mesh is not None:
            squeeze = mesh.all_reduce(squeeze, "model")
        s1 = _act_ref(squeeze + b_se1.float(), se_act)
        gate = _act_ref(s1 @ w_se2.float() + b_se2.float(),
                        gate_act).contiguous()
    if mode == "retain":
        out = mbconv_pass2_retain(dw, gate, w_proj, geo, retain_splits)
    else:
        out = mbconv_pass2_recompute(x, w_exp, w_dw, gate, w_proj, geo,
                                     exp_act=exp_act, dw_act=dw_act)
    if mesh is not None:
        out = reduce_partial(out, mesh, collective, scatter_width)
    return out


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
    retain_splits: Optional[int] = None,
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
    retain_splits : the cap on retain's K splits (the schedule's)
    Returns (B, H', W', C_out).
    """
    args = (x, w_exp, w_dw, w_se1, b_se1, w_se2, b_se2, w_proj)
    conf = dict(stride=stride, padding=padding, tile_h=tile_h,
                tile_w=tile_w, mode=mode, exp_act=exp_act, dw_act=dw_act,
                se_act=se_act, gate_act=gate_act, retain_splits=retain_splits)
    if needs_grad(*args):
        return _MBConvFn.apply(*args, conf)
    return _mbconv_impl(*args, **conf)


def convdk_mbconv_staged(
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
    exp_act: Optional[str] = "silu",
    dw_act: Optional[str] = "silu",
    se_act: Optional[str] = "silu",
    gate_act: Optional[str] = "sigmoid",
) -> torch.Tensor:
    """The STAGED MBConv pipeline (comparison baseline, differentiable),
    counterpart of ``repro.kernels.convdk_mbconv_staged``.

    expand matmul -> device memory -> row strips -> the depthwise kernel
    (``kernels.ops.convdk_depthwise2d``) -> device memory -> SE mean pool
    over the whole DW tensor, MLP and gate -> device memory -> projection
    matmul: the DW tensor round-trips device memory as in the paper's
    weight-stationary baseline, which ``convdk_mbconv_fused`` removes.  The
    matmuls and the SE stay PyTorch calls, as the JAX baseline leaves them
    to XLA.  Layouts as ``convdk_mbconv_fused`` (``w_exp=None`` is the
    identity expand; the four SE operands ``None`` for a no-SE block).
    """
    from .ops import convdk_depthwise2d

    e = x.float() if w_exp is None else x.float() @ w_exp.float()
    e = _act_ref(e, exp_act)
    d = convdk_depthwise2d(e, w_dw.float(), stride=stride, padding=padding,
                           tile_h=tile_h)
    d = _act_ref(d, dw_act)
    if w_se1 is not None:
        pooled = d.mean(dim=(1, 2))
        s1 = _act_ref(pooled @ w_se1.float() + b_se1.float(), se_act)
        gate = _act_ref(s1 @ w_se2.float() + b_se2.float(), gate_act)
        d = d * gate[:, None, None, :]
    return (d @ w_proj.float()).to(x.dtype)
