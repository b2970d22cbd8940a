"""Fused depthwise-separable block (DW + PW in one pass) through a
hand-written CUDA kernel.

Counterpart of ``repro.kernels.convdk_fused``:

    depthwise k x k / s -> dw_act -> pointwise 1x1 (C_in -> C_out) -> act

in ONE launch (``kernels/csrc/separable.cu``: ``fused_separable_kernel``
in fp32, ``fused_separable_mma`` in bf16): the depthwise output never
reaches device memory, the input is read from its unstaged layout, and the
block output is written once.  x, the taps, w_pw and the output are fp32
or bf16 (one storage type, the launch's), every product is exact or fp32,
every sum is fp32 and the output is rounded once, as the JAX kernel
widens its operands to fp32 and casts once to the output's dtype (the
bf16 build multiplies the fp32 depthwise on bf16 tensor cores split
exactly into three bf16 terms).  Where the schedule splits C_in across
CTAs (the late MobileNet-V2 blocks, too small to fill the card
otherwise), the splits' products are summed in split order and ``act``
applied in the same launch (B4', folded in): in fp32 each split writes an
fp32 partial and the last CTA of each output tile sums them, the splits
keeping ``splits * C_out < C_in``, so the partials are smaller than the
depthwise tensor; in bf16 the splits (at most 8) are the CTAs of one
thread-block cluster, which sum in distributed shared memory, so no
partial reaches device memory unless the caller asks for them.

``fused_separable`` launches the kernel for CUDA tensors and runs its
plain version for CPU tensors (``fused_separable_plain``, or for a split
launch the plain partials summed in the kernel's order: fp32 on the
widened inputs, rounded once); any other device raises, as do fp16 and
mixed storage types.
``fused_separable_with_partials`` also returns the split launch's
partials (a bf16 launch stores its ranks' products only for it).
``fused_separable_partials_plain`` and ``fused_separable_reduce_plain``
are the plain versions of the split route, summing in the kernel's
order.  ``LAUNCHES`` counts kernel
launches, the bf16 ones as ``fused_separable_bf16``.
The kernel tiles the output in ``tile_h x tile_w`` pixels, its c_out tile
and splits come from ``core.autotune.fused_separable_launch_plan`` (see
``core.autotune.get_fused_schedule``), and it masks SAME padding and every
ragged pixel and channel edge itself, so the wrapper pads nothing and
slices nothing back.

``convdk_fused_separable`` is differentiable: when an operand requires
grad it goes through an autograd Function whose backward is autograd
through ``separable_ref``, as the JAX package's ``custom_vjp`` backward is
``jax.vjp`` of its oracle (the kernel has no backward of its own, nor had
the Pallas one); at bf16 that oracle rounds its depthwise to bf16, as the
JAX one does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from ..core.autotune import (
    SEP_BF16_MAX_OUT_TILE,
    SEP_BF16_MAX_SPLITS,
    SEP_BF16_TERM_STRIDE,
    SEP_CHUNK_LANES,
    SEP_CI_CHUNK,
    SEP_MAX_TILE_PIXELS,
    SEP_THREADS,
    fused_separable_col_warps,
    fused_separable_launch_plan,
    fused_separable_out_tiles,
    fused_separable_pixel_stride,
    fused_separable_split_counts,
    fused_separable_window_smem_bytes,
)
from . import _build
from .common import (
    ACT_CODES,
    STORAGE,
    arrival_counters,
    check_cuda,
    launch_name,
    needs_grad,
    on_cpu,
    ptr,
    reduce_partial,
    storage_dtype,
    vjp_through,
)
from .convdk_mbconv import MBConvGeometry
from .ref import _act_ref, depthwise_valid, pad_nhwc, separable_ref

KERNELS: Tuple[str, ...] = ("fused_separable", "fused_separable_bf16")
# kernel launches per wrapper (reset with ``reset_launches``)
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int
# (k, window rows, window cols, pixels, c_out tile) probes of the
# shared-memory check
_SMEM_PROBES = ((3, 10, 10, 64, 16), (3, 17, 17, 64, 24), (5, 11, 19, 63, 48),
                (3, 3, 66, 32, 64), (3, 9, 9, 49, 32), (3, 9, 9, 49, 160),
                (3, 6, 9, 28, 56), (3, 3, 3, 1, 112))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/separable.cu`` built and bound (B4 here, B6 for
    ``kernels.convdk_dw``), its tiles and shared-memory budget checked
    against ``core.autotune``."""
    lib = _build.load("separable")
    lib.fused_separable.argtypes = [_P] * 6 + [_I] * 18 + [_P]
    lib.dw2d.argtypes = [_P] * 3 + [_I] * 14 + [_P]
    for fn in (lib.fused_separable, lib.dw2d):
        fn.restype = ctypes.c_int
    lib.separable_error_string.argtypes = [ctypes.c_int]
    lib.separable_error_string.restype = ctypes.c_char_p
    lib.fused_separable_smem_bytes.argtypes = [_I] * 6
    lib.fused_separable_smem_bytes.restype = ctypes.c_size_t
    lib.fused_separable_col_warps.argtypes = [_I]
    pixels = range(1, SEP_MAX_TILE_PIXELS + 1)
    built = (lib.fused_separable_max_tile_pixels(),
             lib.fused_separable_ci_chunk(),
             [lib.fused_separable_pixel_stride(b) for b in (0, 1)],
             lib.fused_separable_threads(),
             {nc: lib.fused_separable_chunk_lanes(nc) for nc in SEP_CHUNK_LANES},
             lib.fused_separable_max_out_tile_bf16(),
             lib.fused_separable_max_cluster(),
             lib.fused_separable_term_stride(),
             [lib.fused_separable_col_warps(p) for p in pixels])
    want = (SEP_MAX_TILE_PIXELS, SEP_CI_CHUNK,
            [fused_separable_pixel_stride(eb) for eb in (4, 2)], SEP_THREADS,
            SEP_CHUNK_LANES, SEP_BF16_MAX_OUT_TILE, SEP_BF16_MAX_SPLITS,
            SEP_BF16_TERM_STRIDE, [fused_separable_col_warps(p) for p in pixels])
    if built != want:
        raise RuntimeError(f"separable.cu tiles {built} disagree with "
                           f"core.autotune {want}")
    for args in _SMEM_PROBES:
        for bf16, eb in ((0, 4), (1, 2)):
            got = lib.fused_separable_smem_bytes(*args, bf16)
            model = fused_separable_window_smem_bytes(*args, eb)
            if got != model:
                raise RuntimeError(
                    f"separable.cu asks for {got} B of shared memory at (k, "
                    f"rows, cols, pixels, c_out tile) {args}, {eb}-byte "
                    f"storage; core.autotune budgets {model} B")
    return lib


def launch_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launcher of ``lib`` returned an error code."""
    if err != 0:
        raise RuntimeError(f"{name} did not launch: "
                           f"{lib.separable_error_string(err).decode()}")


def _check_shapes(x, w_dw, w_pw, geo: MBConvGeometry) -> None:
    _, h, w, c_in = x.shape
    k_h, k_w, c_dw = w_dw.shape
    if (h, w) != (geo.h, geo.w) or (k_h, k_w) != (geo.k, geo.k):
        raise ValueError(f"x {tuple(x.shape)} / w_dw {tuple(w_dw.shape)} "
                         f"do not match {geo}")
    if c_dw != c_in or w_pw.shape[0] != c_in:
        raise ValueError(f"x {tuple(x.shape)}, w_dw {tuple(w_dw.shape)}, "
                         f"w_pw {tuple(w_pw.shape)} do not chain")


def _depthwise_f32(x, w_dw, geo: MBConvGeometry,
                   dw_act: Optional[str]) -> torch.Tensor:
    """dw_act of the zero-padded depthwise, in fp32 on the widened inputs
    (the kernel's depthwise tile)."""
    d = depthwise_valid(pad_nhwc(x.float(), geo.pads), w_dw.float(), geo.s)
    return _act_ref(d, dw_act)


def fused_separable_plain(x, w_dw, w_pw, geo: MBConvGeometry, *,
                          dw_act: Optional[str],
                          act: Optional[str]) -> torch.Tensor:
    """Plain version of ``fused_separable``: zero-pad, depthwise, dw_act,
    pointwise, act, in fp32 on the widened inputs, rounded once to x's
    type."""
    d = _depthwise_f32(x, w_dw, geo, dw_act)
    return _act_ref(d @ w_pw.float(), act).to(x.dtype)


def split_channels(c_in: int, splits: int) -> List[Tuple[int, int]]:
    """The C_in range [lo, hi) of each split: runs of whole SEP_CI_CHUNK
    chunks, ceil(chunks / splits) each (separable.cu's split_chunks)."""
    chunks = -(-c_in // SEP_CI_CHUNK)
    per = -(-chunks // splits)
    return [(s * per * SEP_CI_CHUNK, min(c_in, (s + 1) * per * SEP_CI_CHUNK))
            for s in range(splits)]


def fused_separable_partials_plain(x, w_dw, w_pw, geo: MBConvGeometry, *,
                                   splits: int,
                                   dw_act: Optional[str]) -> torch.Tensor:
    """Plain version of the split kernel: for each split of C_in, the
    depthwise of its channels, dw_act, and their pointwise product ->
    (splits, B, out_h, out_w, C_out) fp32 partials (no act), in fp32 on
    the widened inputs."""
    d = _depthwise_f32(x, w_dw, geo, dw_act)
    w = w_pw.float()
    return torch.stack([d[..., lo:hi] @ w[lo:hi]
                        for lo, hi in split_channels(x.shape[-1], splits)])


def fused_separable_reduce_plain(partial: torch.Tensor, *,
                                 act: Optional[str],
                                 dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
    """Plain version of the split launch's sum (B4'): the fp32 partials
    summed in split order (the kernel's order, so the two agree bit for
    bit), then act, rounded once to ``dtype``."""
    out = partial[0].clone()
    for s in range(1, partial.shape[0]):
        out += partial[s]
    return _act_ref(out, act).to(dtype)


def fused_separable_with_partials(
        x: torch.Tensor, w_dw: torch.Tensor, w_pw: torch.Tensor,
        geo: MBConvGeometry, *, dw_act: Optional[str], act: Optional[str],
        splits: Optional[int] = None, nc: Optional[int] = None,
        partials: bool = True
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``fused_separable`` with its launch's fp32 split partials: (the
    output, the partials (splits, B, out_h, out_w, C_out), or None where
    the launch does not split C_in or ``partials`` is False).  On the card
    one launch writes both, summing the partials in split order and
    applying act (fp32: its last CTA per output tile, from the partials in
    device memory; bf16: each cluster in distributed shared memory, its
    ranks storing their products only where ``partials`` asks); on the CPU
    the plain partials and their sum.  ``splits`` pins the C_in split count
    (one of ``fused_separable_split_counts``) and ``nc`` the c_out tile
    (one of ``fused_separable_out_tiles``), the launch plan's by
    default."""
    _check_shapes(x, w_dw, w_pw, geo)
    dtype = storage_dtype(x, w_dw, w_pw)
    b, h, w, c_in = x.shape
    c_out = w_pw.shape[1]
    eb = dtype.itemsize
    plan_nc, plan = fused_separable_launch_plan(
        b, h, w, c_in, c_out, geo.k, geo.s, geo.tile_h, geo.tile_w, eb)
    allowed = fused_separable_split_counts(c_in, c_out, eb)
    tiles = fused_separable_out_tiles(c_out, geo.k, eb)
    if splits is None:
        splits = plan
    elif splits not in allowed:
        raise ValueError(f"{splits} C_in splits: the launch takes one of "
                         f"{allowed} at C_in {c_in}, C_out {c_out}, "
                         f"{eb}-byte storage")
    if nc is None:
        nc = plan_nc
    elif nc not in tiles:
        raise ValueError(f"c_out tile {nc}: the launch takes one of {tiles} "
                         f"at C_out {c_out}, {eb}-byte storage")
    if on_cpu(x):
        if splits == 1:
            return fused_separable_plain(x, w_dw, w_pw, geo, dw_act=dw_act,
                                         act=act), None
        part = fused_separable_partials_plain(x, w_dw, w_pw, geo,
                                              splits=splits, dw_act=dw_act)
        return (fused_separable_reduce_plain(part, act=act, dtype=dtype),
                part if partials else None)
    check_cuda(x, w_dw, w_pw, dtypes=STORAGE)
    shape = (b, geo.out_h, geo.out_w, c_out)
    out = torch.empty(shape, device=x.device, dtype=dtype)
    part = counters = None
    if splits > 1 and (partials or eb == 4):
        part = torch.empty((splits, *shape), device=x.device)
    if splits > 1 and eb == 4:
        counters = arrival_counters(x.device,
                                    geo.n_tiles * -(-c_out // nc) * b,
                                    "fused_separable")
    lib = _lib()
    launch_error(lib, "fused_separable", lib.fused_separable(
        ptr(x), ptr(w_dw), ptr(w_pw), ptr(part), ptr(counters), ptr(out), b,
        h, w, c_in, c_out, geo.k, geo.s, geo.out_h, geo.out_w,
        geo.pads[0][0], geo.pads[1][0], geo.tile_h, geo.tile_w, nc, splits,
        ACT_CODES[dw_act], ACT_CODES[act], int(dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream))
    LAUNCHES[launch_name("fused_separable", dtype)] += 1
    return out, part if partials else None


def fused_separable(x: torch.Tensor, w_dw: torch.Tensor, w_pw: torch.Tensor,
                    geo: MBConvGeometry, *, dw_act: Optional[str],
                    act: Optional[str]) -> torch.Tensor:
    """Depthwise -> dw_act -> pointwise -> act -> (B, out_h, out_w, C_out)
    at x's storage type (fp32 or bf16, the weights' too); on the card one
    launch, split over C_in or not (in bf16 with no partial tensor)."""
    return fused_separable_with_partials(x, w_dw, w_pw, geo, dw_act=dw_act,
                                         act=act, partials=False)[0]


def _fused_impl(x, w_dw, w_pw, geo: MBConvGeometry, *,
                dw_act: Optional[str], act: Optional[str], mesh=None,
                collective: str = "ring_allreduce",
                scatter_width: int = 0) -> torch.Tensor:
    """``fused_separable`` on one device, or, when ``mesh`` is given, on
    one rank's slice of C_in (the sharded-in route of
    ``kernels.convdk_sharded``): the depthwise is channel-local on the
    slice, the pointwise partial over the local C_in rows crosses the
    "model" group per ``collective`` (``common.reduce_partial``), and
    ``act``, being nonlinear, is applied after the reduction (the kernel
    runs with none)."""
    if mesh is None:
        return fused_separable(x, w_dw, w_pw, geo, dw_act=dw_act, act=act)
    out = fused_separable(x, w_dw, w_pw, geo, dw_act=dw_act, act=None)
    return _act_ref(reduce_partial(out, mesh, collective, scatter_width),
                    act)


class _FusedSeparableFn(torch.autograd.Function):
    """``fused_separable`` forward; backward through ``separable_ref``."""

    @staticmethod
    def forward(ctx, x, w_dw, w_pw, geo, padding, dw_act, act):
        ctx.save_for_backward(x, w_dw, w_pw)
        ctx.conf = (geo.s, padding, dw_act, act)
        return fused_separable(x, w_dw, w_pw, geo, dw_act=dw_act, act=act)

    @staticmethod
    def backward(ctx, grad_out):
        stride, padding, dw_act, act = ctx.conf

        def ref(x, w_dw, w_pw):
            return separable_ref(x, w_dw, w_pw, stride, padding, dw_act, act)

        return (*vjp_through(ref, ctx.saved_tensors, grad_out,
                             ctx.needs_input_grad[:3]),
                None, None, None, None)


def convdk_fused_separable(
    x: torch.Tensor,
    w_dw: torch.Tensor,
    w_pw: torch.Tensor,
    *,
    stride: int = 1,
    padding: str = "SAME",
    tile_h: int = 8,
    tile_w: int = 8,
    dw_act: Optional[str] = None,
    act: Optional[str] = None,
) -> torch.Tensor:
    """Fused depthwise-separable block, ``act(pw(dw_act(dw(x))))``, in one
    kernel launch.  Layouts as ``repro.kernels.convdk_fused_separable``:

    x    : (B, H, W, C_in) NHWC
    w_dw : (k, k, C_in) depthwise taps
    w_pw : (C_in, C_out) pointwise projection
    dw_act / act : None | "relu" | "relu6"
    All three fp32 or all bf16 (fp32 sums, the output rounded once).
    Returns (B, H', W', C_out) at that type.
    """
    k_h, k_w = w_dw.shape[:2]
    if k_h != k_w:
        raise ValueError(f"square depthwise kernels only, got {k_h}x{k_w}")
    geo = MBConvGeometry.make(x.shape[1], x.shape[2], k_h, stride, padding,
                              tile_h, tile_w)
    if needs_grad(x, w_dw, w_pw):
        return _FusedSeparableFn.apply(x, w_dw, w_pw, geo, padding, dw_act,
                                       act)
    return fused_separable(x, w_dw, w_pw, geo, dw_act=dw_act, act=act)
