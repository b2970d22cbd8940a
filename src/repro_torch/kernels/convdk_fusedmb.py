"""Single-pass Fused-MBConv (EfficientNet-V2) through a hand-written CUDA
kernel.

Counterpart of ``repro.kernels.convdk_fusedmb``:

    dense k x k / s conv (C_in -> C_mid) -> act -> project 1x1

in ONE launch (``kernels/csrc/fusedmb.cu``): the expanded (C_mid) tensor
never reaches device memory, there is no SE stage and no second pass.

``fusedmb`` launches the kernel for CUDA tensors and runs
``fusedmb_plain`` for CPU tensors; any other device raises.  ``LAUNCHES``
counts kernel launches.  The kernel tiles the output in ``tile_h x
tile_w`` pixels (see ``core.autotune.get_fusedmb_schedule``), walks C_mid
in chunks of ``core.autotune.fusedmb_chunk`` channels (also its c_out
tile) and masks SAME padding and every ragged edge itself, so the wrapper
pads nothing.

``convdk_fusedmb_fused`` is differentiable: when an operand requires grad
it goes through an autograd Function whose backward is autograd through
``fusedmb_ref``, as the JAX package's ``custom_vjp`` backward is
``jax.vjp`` of its oracle.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.autotune import (
    FMB_CHUNK_LANES,
    FMB_MAX_TILE_PIXELS,
    FMB_PIXELS_PER_THREAD,
    FMB_SLOTS,
    fusedmb_launch_plan,
    fusedmb_window_smem_bytes,
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
from .ref import _act_ref, fusedmb_ref, pad_nhwc

KERNELS: Tuple[str, ...] = ("fusedmb",)
# kernel launches per wrapper (reset with ``reset_launches``)
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int
# (window rows, window cols, ci_chunk, chunk) probes of the shared-memory
# check: whole and chunked windows, every chunk
_SMEM_PROBES = ((10, 10, 24, 24), (17, 33, 24, 48), (10, 14, 48, 48),
                (8, 10, 64, 64), (11, 19, 70, 32), (19, 19, 40, 64))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fusedmb")
    lib.fusedmb.argtypes = [_P] * 4 + [_I] * 17 + [_P]
    lib.fusedmb.restype = ctypes.c_int
    lib.fusedmb_error_string.argtypes = [ctypes.c_int]
    lib.fusedmb_error_string.restype = ctypes.c_char_p
    lib.fusedmb_smem_bytes.argtypes = [_I] * 4
    lib.fusedmb_smem_bytes.restype = ctypes.c_size_t
    built = (lib.fusedmb_max_tile_pixels(), lib.fusedmb_pixels_per_thread(),
             lib.fusedmb_ring_slots(),
             {nc: lib.fusedmb_chunk_lanes(nc) for nc in FMB_CHUNK_LANES})
    want = (FMB_MAX_TILE_PIXELS, FMB_PIXELS_PER_THREAD, FMB_SLOTS,
            FMB_CHUNK_LANES)
    if built != want:
        raise RuntimeError(f"fusedmb.cu tiles {built} disagree with "
                           f"core.autotune {want}")
    # the solver's shared-memory budget against the launcher's
    for args in _SMEM_PROBES:
        got = lib.fusedmb_smem_bytes(*args)
        model = fusedmb_window_smem_bytes(*args)
        if got != model:
            raise RuntimeError(f"fusedmb.cu asks for {got} B of shared "
                               f"memory at (rows, cols, ci_chunk, chunk) "
                               f"{args}; core.autotune budgets "
                               f"{model} B")
    return lib


def _check_shapes(x, w_conv, w_proj, geo: MBConvGeometry) -> None:
    _, h, w, c_in = x.shape
    k_h, k_w, ci_w, c_mid = w_conv.shape
    if (h, w) != (geo.h, geo.w) or (k_h, k_w) != (geo.k, geo.k):
        raise ValueError(f"x {tuple(x.shape)} / w_conv {tuple(w_conv.shape)} "
                         f"do not match {geo}")
    if ci_w != c_in or w_proj.shape[0] != c_mid:
        raise ValueError(f"x {tuple(x.shape)}, w_conv {tuple(w_conv.shape)}, "
                         f"w_proj {tuple(w_proj.shape)} do not chain")


def fusedmb_plain(x, w_conv, w_proj, geo: MBConvGeometry, *,
                  act: Optional[str]) -> torch.Tensor:
    """Plain version of ``fusedmb``: zero-pad, dense conv, act, project."""
    xp = pad_nhwc(x, geo.pads).permute(0, 3, 1, 2)
    e = F.conv2d(xp, w_conv.permute(3, 2, 0, 1), stride=geo.s)
    return _act_ref(e.permute(0, 2, 3, 1), act) @ w_proj


def fusedmb(x: torch.Tensor, w_conv: torch.Tensor, w_proj: torch.Tensor,
            geo: MBConvGeometry, *, act: Optional[str]) -> torch.Tensor:
    """Dense conv -> act -> projection -> (B, out_h, out_w, C_out)."""
    _check_shapes(x, w_conv, w_proj, geo)
    if on_cpu(x):
        return fusedmb_plain(x, w_conv, w_proj, geo, act=act)
    check_cuda(x, w_conv, w_proj, dtypes=FP32)
    b, h, w, c_in = x.shape
    c_mid, c_out = w_proj.shape
    nc, ci_chunk = fusedmb_launch_plan(c_in, c_mid, c_out, geo.k, geo.s,
                                       geo.tile_h, geo.tile_w)
    out = torch.empty((b, geo.out_h, geo.out_w, c_out), device=x.device)
    lib = _lib()
    err = lib.fusedmb(ptr(x), ptr(w_conv), ptr(w_proj), ptr(out), b, h, w,
                      c_in, c_mid, c_out, geo.k, geo.s, geo.out_h, geo.out_w,
                      geo.pads[0][0], geo.pads[1][0], geo.tile_h, geo.tile_w,
                      nc, ci_chunk, ACT_CODES[act],
                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("fusedmb did not launch: "
                           f"{lib.fusedmb_error_string(err).decode()}")
    LAUNCHES["fusedmb"] += 1
    return out


class _FusedMBFn(torch.autograd.Function):
    """``fusedmb`` forward; backward through ``fusedmb_ref``."""

    @staticmethod
    def forward(ctx, x, w_conv, w_proj, geo, padding, act):
        ctx.save_for_backward(x, w_conv, w_proj)
        ctx.conf = (geo.s, padding, act)
        return fusedmb(x, w_conv, w_proj, geo, act=act)

    @staticmethod
    def backward(ctx, grad_out):
        stride, padding, act = ctx.conf

        def ref(x, w_conv, w_proj):
            return fusedmb_ref(x, w_conv, w_proj, stride, padding, act)

        return (*vjp_through(ref, ctx.saved_tensors, grad_out,
                             ctx.needs_input_grad[:3]), None, None, None)


def convdk_fusedmb_fused(
    x: torch.Tensor,
    w_conv: torch.Tensor,
    w_proj: torch.Tensor,
    *,
    stride: int = 1,
    padding: str = "SAME",
    tile_h: int = 8,
    tile_w: int = 8,
    act: Optional[str] = "silu",
) -> torch.Tensor:
    """Single-pass fused Fused-MBConv block, no residual add (the model
    layer owns it).  Layouts as ``repro.kernels.convdk_fusedmb_fused``:

    x      : (B, H, W, C_in) NHWC
    w_conv : (k, k, C_in, C_mid) HWIO dense conv
    w_proj : (C_mid, C_out)
    Returns (B, H', W', C_out).
    """
    k_h, k_w = w_conv.shape[:2]
    if k_h != k_w:
        raise ValueError(f"square dense kernels only, got {k_h}x{k_w}")
    geo = MBConvGeometry.make(x.shape[1], x.shape[2], k_h, stride, padding,
                              tile_h, tile_w)
    if needs_grad(x, w_conv, w_proj):
        return _FusedMBFn.apply(x, w_conv, w_proj, geo, padding, act)
    return fusedmb(x, w_conv, w_proj, geo, act=act)
