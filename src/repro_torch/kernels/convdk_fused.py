"""Fused depthwise-separable block (DW + PW in one pass) through a
hand-written CUDA kernel.

Counterpart of ``repro.kernels.convdk_fused``:

    depthwise k x k / s -> dw_act -> pointwise 1x1 (C_in -> C_out) -> act

in ONE launch (``kernels/csrc/separable.cu`` ``fused_separable_kernel``):
the depthwise output never reaches device memory, the input is read from
its unstaged layout, and the block output is written once.

``fused_separable`` launches the kernel for CUDA tensors and runs
``fused_separable_plain`` for CPU tensors; any other device raises.
``LAUNCHES`` counts kernel launches.  The kernel tiles the output in
``tile_h x tile_w`` pixels (see ``core.autotune.get_fused_schedule``) and
masks SAME padding and every ragged pixel and channel edge itself, so the
wrapper pads nothing and slices nothing back.

``convdk_fused_separable`` is differentiable: when an operand requires
grad it goes through an autograd Function whose backward is autograd
through ``separable_ref``, as the JAX package's ``custom_vjp`` backward is
``jax.vjp`` of its oracle (the kernel has no backward of its own, nor had
the Pallas one).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from ..core.autotune import (
    C_BLOCK,
    MAX_TILE_PIXELS,
    PIXEL_STRIDE,
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

KERNELS: Tuple[str, ...] = ("fused_separable",)
# kernel launches per wrapper (reset with ``reset_launches``)
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int
# (k, window rows, window cols, c_out) probes of the shared-memory check
_SMEM_PROBES = ((3, 10, 10, 16), (3, 17, 17, 64), (5, 11, 19, 130),
                (3, 3, 66, 320))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/separable.cu`` built and bound (B4 here, B6 for
    ``kernels.convdk_dw``), its tiles and shared-memory budget checked
    against ``core.autotune``."""
    lib = _build.load("separable")
    lib.fused_separable.argtypes = [_P] * 4 + [_I] * 15 + [_P]
    lib.dw2d.argtypes = [_P] * 3 + [_I] * 9 + [_P]
    lib.fused_separable.restype = lib.dw2d.restype = ctypes.c_int
    lib.separable_error_string.argtypes = [ctypes.c_int]
    lib.separable_error_string.restype = ctypes.c_char_p
    lib.fused_separable_smem_bytes.argtypes = [_I] * 4
    lib.fused_separable_smem_bytes.restype = ctypes.c_size_t
    built = (lib.separable_channel_tile(), lib.separable_max_tile_pixels(),
             lib.separable_pixel_stride())
    want = (C_BLOCK, MAX_TILE_PIXELS, PIXEL_STRIDE)
    if built != want:
        raise RuntimeError(f"separable.cu tiles {built} disagree with "
                           f"core.autotune {want}")
    for args in _SMEM_PROBES:
        got = lib.fused_separable_smem_bytes(*args)
        model = fused_separable_window_smem_bytes(*args)
        if got != model:
            raise RuntimeError(f"separable.cu asks for {got} B of shared "
                               f"memory at (k, rows, cols, c_out) {args}; "
                               f"core.autotune budgets {model} B")
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


def fused_separable(x: torch.Tensor, w_dw: torch.Tensor, w_pw: torch.Tensor,
                    geo: MBConvGeometry, *, dw_act: Optional[str],
                    act: Optional[str]) -> torch.Tensor:
    """Depthwise -> dw_act -> pointwise -> act -> (B, out_h, out_w, C_out)."""
    _check_shapes(x, w_dw, w_pw, geo)
    if on_cpu(x):
        return fused_separable_plain(x, w_dw, w_pw, geo, dw_act=dw_act,
                                     act=act)
    check_cuda(x, w_dw, w_pw, dtypes=FP32)
    b, h, w, c_in = x.shape
    c_out = w_pw.shape[1]
    out = torch.empty((b, geo.out_h, geo.out_w, c_out), device=x.device)
    lib = _lib()
    launch_error(lib, "fused_separable", lib.fused_separable(
        ptr(x), ptr(w_dw), ptr(w_pw), ptr(out), b, h, w, c_in, c_out, geo.k,
        geo.s, geo.out_h, geo.out_w, geo.pads[0][0], geo.pads[1][0],
        geo.tile_h, geo.tile_w, ACT_CODES[dw_act], ACT_CODES[act],
        torch.cuda.current_stream().cuda_stream))
    LAUNCHES["fused_separable"] += 1
    return out


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
