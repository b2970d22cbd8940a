"""Depthwise Conv2D over pre-staged row strips through a hand-written CUDA
kernel.

Counterpart of ``repro.kernels.convdk_dw``: ``dw2d`` runs the depthwise
k x k / s conv over the overlapping row strips that
``kernels.ops.stage_row_strips`` writes to device memory (the staged
baseline's IB->TRF analogue), one launch of ``dw2d_kernel``
(``kernels/csrc/separable.cu``) for CUDA tensors and ``dw2d_plain`` for
CPU tensors; any other device raises.  ``LAUNCHES`` counts kernel
launches.  Ragged channel counts are masked in the kernel, so nothing is
padded to a channel block.  The strips and taps are fp32 or bf16 (one
dtype for both); the sums are fp32 and the output is rounded once to that
dtype, as the Pallas kernel writes ``o_ref.dtype``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .common import check_cuda, on_cpu, ptr
from .convdk_fused import _lib, launch_error
from .ref import depthwise_valid

KERNELS: Tuple[str, ...] = ("dw2d",)
DTYPES: Tuple[torch.dtype, ...] = (torch.float32, torch.bfloat16)
# kernel launches per wrapper (reset with ``reset_launches``)
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
         out_w: int, tile_h: int) -> torch.Tensor:
    """x_strips (B, n_th, (tile_h-1)*s + k, W_pad, C), w (k, k, C) ->
    (B, n_th, tile_h, out_w, C)."""
    _check_shapes(x_strips, w, stride, out_w, tile_h)
    if on_cpu(x_strips):
        return dw2d_plain(x_strips, w, stride=stride, out_w=out_w,
                          tile_h=tile_h)
    check_cuda(x_strips, w, dtypes=DTYPES)
    if w.dtype != x_strips.dtype:
        raise ValueError(f"strips {x_strips.dtype} and taps {w.dtype}: the "
                         f"kernel takes one dtype")
    b, n_th, in_rows, w_pad, c = x_strips.shape
    out = torch.empty((b, n_th, tile_h, out_w, c), device=x_strips.device,
                      dtype=x_strips.dtype)
    lib = _lib()
    launch_error(lib, "dw2d", lib.dw2d(
        ptr(x_strips), ptr(w), ptr(out), b, n_th, in_rows, w_pad, c,
        w.shape[0], stride, tile_h, out_w,
        int(x_strips.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream))
    LAUNCHES["dw2d"] += 1
    return out
