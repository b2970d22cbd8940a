"""Fused depthwise-separable block (DW + PW in one pass) through a
hand-written CUDA kernel.

Counterpart of ``repro.kernels.convdk_fused``:

    depthwise k x k / s -> dw_act -> pointwise 1x1 (C_in -> C_out) -> act

in ONE launch (``kernels/csrc/separable.cu`` ``fused_separable_kernel``)
where C_in is not split: the depthwise output never reaches device memory,
the input is read from its unstaged layout, and the block output is
written once.  Where the schedule splits C_in across CTAs (the late
MobileNet-V2 blocks, too small to fill the card otherwise), each split
writes an fp32 partial product and ``fused_separable_reduce_kernel`` (B4')
sums the partials in split order and applies ``act``; the splits keep
``splits * C_out < C_in``, so the partials are smaller than the depthwise
tensor.

``fused_separable`` launches the kernel (and the reduce) for CUDA tensors
and runs ``fused_separable_plain`` for CPU tensors; any other device
raises.  ``fused_separable_partials_plain`` and
``fused_separable_reduce_plain`` are the plain versions of the split
route, summing in the kernels' order.  ``LAUNCHES`` counts kernel launches.
The kernel tiles the output in ``tile_h x tile_w`` pixels, its c_out tile
and splits come from ``core.autotune.fused_separable_launch_plan`` (see
``core.autotune.get_fused_schedule``), and it masks SAME padding and every
ragged pixel and channel edge itself, so the wrapper pads nothing and
slices nothing back.

``convdk_fused_separable`` is differentiable: when an operand requires
grad it goes through an autograd Function whose backward is autograd
through ``separable_ref``, as the JAX package's ``custom_vjp`` backward is
``jax.vjp`` of its oracle (the kernel has no backward of its own, nor had
the Pallas one).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from ..core.autotune import (
    SEP_CHUNK_LANES,
    SEP_CI_CHUNK,
    SEP_MAX_TILE_PIXELS,
    SEP_PIXEL_STRIDE,
    SEP_THREADS,
    fused_separable_launch_plan,
    fused_separable_window_smem_bytes,
)
from . import _build
from .common import (
    ACT_CODES,
    FP32,
    check_cuda,
    needs_grad,
    on_cpu,
    ptr,
    vjp_through,
)
from .convdk_mbconv import MBConvGeometry
from .ref import _act_ref, depthwise_valid, pad_nhwc, separable_ref

KERNELS: Tuple[str, ...] = ("fused_separable", "fused_separable_reduce")
# kernel launches per wrapper (reset with ``reset_launches``)
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int
# (k, window rows, window cols, pixels, c_out tile) probes of the
# shared-memory check
_SMEM_PROBES = ((3, 10, 10, 64, 16), (3, 17, 17, 64, 24), (5, 11, 19, 63, 48),
                (3, 3, 66, 32, 64), (3, 9, 9, 49, 32))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/separable.cu`` built and bound (B4 and B4' here, B6 for
    ``kernels.convdk_dw``), its tiles and shared-memory budget checked
    against ``core.autotune``."""
    lib = _build.load("separable")
    lib.fused_separable.argtypes = [_P] * 4 + [_I] * 17 + [_P]
    lib.fused_separable_reduce.argtypes = [_P, _P, ctypes.c_longlong, _I, _I,
                                           _P]
    lib.dw2d.argtypes = [_P] * 3 + [_I] * 10 + [_P]
    for fn in (lib.fused_separable, lib.fused_separable_reduce, lib.dw2d):
        fn.restype = ctypes.c_int
    lib.separable_error_string.argtypes = [ctypes.c_int]
    lib.separable_error_string.restype = ctypes.c_char_p
    lib.fused_separable_smem_bytes.argtypes = [_I] * 5
    lib.fused_separable_smem_bytes.restype = ctypes.c_size_t
    built = (lib.fused_separable_max_tile_pixels(),
             lib.fused_separable_ci_chunk(),
             lib.fused_separable_pixel_stride(),
             lib.fused_separable_threads(),
             {nc: lib.fused_separable_chunk_lanes(nc) for nc in SEP_CHUNK_LANES})
    want = (SEP_MAX_TILE_PIXELS, SEP_CI_CHUNK, SEP_PIXEL_STRIDE, SEP_THREADS,
            SEP_CHUNK_LANES)
    if built != want:
        raise RuntimeError(f"separable.cu tiles {built} disagree with "
                           f"core.autotune {want}")
    for args in _SMEM_PROBES:
        got = lib.fused_separable_smem_bytes(*args)
        model = fused_separable_window_smem_bytes(*args)
        if got != model:
            raise RuntimeError(f"separable.cu asks for {got} B of shared "
                               f"memory at (k, rows, cols, pixels, c_out "
                               f"tile) {args}; core.autotune budgets "
                               f"{model} B")
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


def fused_separable_plain(x, w_dw, w_pw, geo: MBConvGeometry, *,
                          dw_act: Optional[str],
                          act: Optional[str]) -> torch.Tensor:
    """Plain version of ``fused_separable``: zero-pad, depthwise, dw_act,
    pointwise, act."""
    d = depthwise_valid(pad_nhwc(x, geo.pads), w_dw, geo.s)
    return _act_ref(_act_ref(d, dw_act) @ w_pw, act)


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
    (splits, B, out_h, out_w, C_out) fp32 partials (no act)."""
    d = _act_ref(depthwise_valid(pad_nhwc(x, geo.pads), w_dw, geo.s), dw_act)
    return torch.stack([d[..., lo:hi] @ w_pw[lo:hi]
                        for lo, hi in split_channels(x.shape[-1], splits)])


def fused_separable_reduce_plain(partial: torch.Tensor, *,
                                 act: Optional[str]) -> torch.Tensor:
    """Plain version of ``fused_separable_reduce``: the partials summed in
    split order (the kernel's order, so the two agree bit for bit), then
    act."""
    out = partial[0].clone()
    for s in range(1, partial.shape[0]):
        out += partial[s]
    return _act_ref(out, act)


def fused_separable_reduce(partial: torch.Tensor, *,
                           act: Optional[str]) -> torch.Tensor:
    """B4': (splits, ...) fp32 partials -> act(their sum in split order)."""
    if on_cpu(partial):
        return fused_separable_reduce_plain(partial, act=act)
    check_cuda(partial, dtypes=FP32)
    out = torch.empty(partial.shape[1:], device=partial.device)
    lib = _lib()
    launch_error(lib, "fused_separable_reduce", lib.fused_separable_reduce(
        ptr(partial), ptr(out), out.numel(), partial.shape[0],
        ACT_CODES[act], torch.cuda.current_stream().cuda_stream))
    LAUNCHES["fused_separable_reduce"] += 1
    return out


def fused_separable(x: torch.Tensor, w_dw: torch.Tensor, w_pw: torch.Tensor,
                    geo: MBConvGeometry, *, dw_act: Optional[str],
                    act: Optional[str]) -> torch.Tensor:
    """Depthwise -> dw_act -> pointwise -> act -> (B, out_h, out_w, C_out);
    on the card one launch, or the split launch and the reduce (B4')."""
    _check_shapes(x, w_dw, w_pw, geo)
    if on_cpu(x):
        return fused_separable_plain(x, w_dw, w_pw, geo, dw_act=dw_act,
                                     act=act)
    check_cuda(x, w_dw, w_pw, dtypes=FP32)
    b, h, w, c_in = x.shape
    c_out = w_pw.shape[1]
    nc, splits = fused_separable_launch_plan(b, h, w, c_in, c_out, geo.k,
                                             geo.s, geo.tile_h, geo.tile_w)
    out = torch.empty((splits, b, geo.out_h, geo.out_w, c_out),
                      device=x.device)
    lib = _lib()
    launch_error(lib, "fused_separable", lib.fused_separable(
        ptr(x), ptr(w_dw), ptr(w_pw), ptr(out), b, h, w, c_in, c_out, geo.k,
        geo.s, geo.out_h, geo.out_w, geo.pads[0][0], geo.pads[1][0],
        geo.tile_h, geo.tile_w, nc, splits, ACT_CODES[dw_act],
        ACT_CODES[act], torch.cuda.current_stream().cuda_stream))
    LAUNCHES["fused_separable"] += 1
    return out[0] if splits == 1 else fused_separable_reduce(out, act=act)


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
    Returns (B, H', W', C_out).
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
