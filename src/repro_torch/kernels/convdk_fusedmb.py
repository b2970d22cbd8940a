"""Single-pass Fused-MBConv (EfficientNet-V2) through a hand-written CUDA
kernel.

Counterpart of ``repro.kernels.convdk_fusedmb``:

    dense k x k / s conv (C_in -> C_mid) -> act -> project 1x1

in ONE launch (``kernels/csrc/fusedmb.cu``): the expanded (C_mid) tensor
never reaches device memory, there is no SE stage and no second pass.

``fusedmb`` launches the kernel for CUDA tensors and runs
``fusedmb_plain`` for CPU tensors; any other device raises.  ``LAUNCHES``
counts kernel launches.  The kernel tiles the output in ``tile_h x
tile_w`` pixels (see ``core.autotune.get_fusedmb_schedule``); its fp32
build walks C_mid in chunks of ``core.autotune.fusedmb_chunk`` channels
(also its c_out tile), its bf16 build (bf16 tensor cores) in chunks of
``core.autotune.fusedmb_mid_chunk`` (32 or 64) with a c_out tile of
``core.autotune.fusedmb_out_tile`` channels.
Both mask SAME padding and every ragged edge themselves, so the wrapper
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
    FMB_BF16_MID_CHUNKS,
    FMB_CHUNK_LANES,
    fusedmb_build_tiles,
    fusedmb_launch_plan,
    fusedmb_mid_chunk,
    fusedmb_window_smem_bytes,
)
from . import _build
from .common import (
    ACT_CODES,
    STORAGE,
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
from .ref import _act_ref, fusedmb_ref, pad_nhwc

KERNELS: Tuple[str, ...] = ("fusedmb",
                            launch_name("fusedmb", torch.bfloat16))
# kernel launches per storage type (reset with ``reset_launches``)
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int
# (window rows, window cols, ci_chunk, chunk) probes of the shared-memory
# check: whole and chunked windows, every chunk
_SMEM_PROBES = ((10, 10, 24, 24), (17, 33, 24, 48), (10, 14, 48, 48),
                (8, 10, 64, 64), (11, 19, 70, 32), (19, 19, 40, 64))
# the library of each storage type (kernels/_build.py's VARIANTS)
_LIBRARIES = {torch.float32: "fusedmb", torch.bfloat16: "fusedmb_bf16"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib(dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    """The bound build of fusedmb.cu for the storage type ``dtype`` (fp32
    FMAs, or bf16 tensor cores), its tiles and shared-memory formula held
    against core.autotune's."""
    lib = _build.load(_LIBRARIES[dtype])
    lib.fusedmb.argtypes = [_P] * 4 + [_I] * 18 + [_P]
    lib.fusedmb.restype = ctypes.c_int
    lib.fusedmb_error_string.argtypes = [ctypes.c_int]
    lib.fusedmb_error_string.restype = ctypes.c_char_p
    lib.fusedmb_smem_bytes.argtypes = [_I] * 5
    lib.fusedmb_smem_bytes.restype = ctypes.c_size_t
    built = (lib.fusedmb_element_bytes(), lib.fusedmb_max_tile_pixels(),
             lib.fusedmb_ring_slots(), lib.fusedmb_pixels_per_thread(),
             {nc: lib.fusedmb_chunk_lanes(nc) for nc in FMB_CHUNK_LANES},
             {cm: lib.fusedmb_groups_per_warp(cm)
              for cm in FMB_BF16_MID_CHUNKS},
             lib.fusedmb_k16_per_slot())
    want = fusedmb_build_tiles(dtype.itemsize)
    if built != want:
        raise RuntimeError(f"fusedmb.cu tiles {built} disagree with "
                           f"core.autotune {want}")
    # the solver's shared-memory budget against the launcher's, at each
    # c_mid chunk of the bf16 build
    for args in _SMEM_PROBES:
        for cm in (FMB_BF16_MID_CHUNKS if dtype.itemsize == 2 else (0,)):
            got = lib.fusedmb_smem_bytes(*args, cm)
            model = fusedmb_window_smem_bytes(*args, eb=dtype.itemsize,
                                              cm=cm)
            if got != model:
                raise RuntimeError(
                    f"fusedmb.cu asks for {got} B of shared memory at "
                    f"(rows, cols, ci_chunk, chunk, c_mid chunk) "
                    f"{(*args, cm)}; core.autotune budgets {model} B")
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
    """Plain version of ``fusedmb``: zero-pad, dense conv, act, project,
    in fp32 from the storage-type operands, rounded once to x's dtype."""
    xp = pad_nhwc(x.float(), geo.pads).permute(0, 3, 1, 2)
    e = F.conv2d(xp, w_conv.float().permute(3, 2, 0, 1), stride=geo.s)
    return (_act_ref(e.permute(0, 2, 3, 1), act)
            @ w_proj.float()).to(x.dtype)


def fusedmb(x: torch.Tensor, w_conv: torch.Tensor, w_proj: torch.Tensor,
            geo: MBConvGeometry, *, act: Optional[str]) -> torch.Tensor:
    """Dense conv -> act -> projection -> (B, out_h, out_w, C_out), in x's
    storage type (fp32 or bf16; fp32 sums, the output rounded once)."""
    _check_shapes(x, w_conv, w_proj, geo)
    dtype = storage_dtype(x, w_conv, w_proj)
    if on_cpu(x):
        return fusedmb_plain(x, w_conv, w_proj, geo, act=act)
    check_cuda(x, w_conv, w_proj, dtypes=STORAGE)
    b, h, w, c_in = x.shape
    c_mid, c_out = w_proj.shape
    nc, ci_chunk = fusedmb_launch_plan(c_in, c_mid, c_out, geo.k, geo.s,
                                       geo.tile_h, geo.tile_w,
                                       dtype.itemsize)
    cm = fusedmb_mid_chunk(c_mid) if dtype.itemsize == 2 else 0
    out = torch.empty((b, geo.out_h, geo.out_w, c_out), device=x.device,
                      dtype=dtype)
    lib = _lib(dtype)
    err = lib.fusedmb(ptr(x), ptr(w_conv), ptr(w_proj), ptr(out), b, h, w,
                      c_in, c_mid, c_out, geo.k, geo.s, geo.out_h, geo.out_w,
                      geo.pads[0][0], geo.pads[1][0], geo.tile_h, geo.tile_w,
                      nc, cm, ci_chunk, ACT_CODES[act],
                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fusedmb ({dtype}) did not launch: "
                           f"{lib.fusedmb_error_string(err).decode()}")
    LAUNCHES[launch_name("fusedmb", dtype)] += 1
    return out


def _fusedmb_impl(x, w_conv, w_proj, geo: MBConvGeometry, *,
                  act: Optional[str], mesh=None,
                  collective: str = "ring_allreduce",
                  scatter_width: int = 0) -> torch.Tensor:
    """``fusedmb`` on one device, or on one rank's slice of the c_mid grid
    when ``mesh`` is given: the dense conv is channel-local there (each
    rank holds all of c_in), and the projection partial crosses the
    "model" group per ``collective`` (``common.reduce_partial``).  There is
    no SE stage, so no other collective."""
    out = fusedmb(x, w_conv, w_proj, geo, act=act)
    if mesh is not None:
        out = reduce_partial(out, mesh, collective, scatter_width)
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


def convdk_fusedmb_staged(
    x: torch.Tensor,
    w_conv: torch.Tensor,
    w_proj: torch.Tensor,
    *,
    stride: int = 1,
    padding: str = "SAME",
    tile_h: int = 8,
    act: Optional[str] = "silu",
) -> torch.Tensor:
    """The STAGED Fused-MBConv pipeline (comparison baseline,
    differentiable), counterpart of ``repro.kernels.convdk_fusedmb_staged``:
    dense conv (``F.conv2d``) -> device memory -> act -> projection matmul.
    The expanded (B, H', W', C_mid) tensor round-trips device memory, which
    ``convdk_fusedmb_fused`` removes.  ``tile_h`` is accepted for call-site
    symmetry with the fused entry and ignored: the staged rendering has no
    strips.  Layouts as ``convdk_fusedmb_fused``.  These are the very
    calls of the oracle ``fusedmb_ref``, each writing its tensor out."""
    del tile_h
    return fusedmb_ref(x, w_conv, w_proj, stride, padding, act)
