"""Causal depthwise Conv1D (+ bias, optional SiLU) through a hand-written
CUDA kernel.

Counterpart of ``repro.kernels.convdk_conv1d``: ``conv1d`` computes

    out[b, t, d] = act(bias[d] + sum_i w[i, d] * x[b, t - k + 1 + i, d])

with x zero before t = 0, in one launch of ``causal_conv1d_kernel``
(``kernels/csrc/conv1d.cu``) for CUDA tensors and ``conv1d_plain`` for CPU
tensors; any other device raises.  ``LAUNCHES`` counts kernel launches.
The kernel reads the unstaged (B, L, D) input and loads each L tile's
causal halo itself, so the strips the JAX wrapper stages in HBM
(``kernels.ops.stage_seq_strips``) are never written; ragged channel counts
are masked in the kernel, so nothing is padded to a channel block.

x is fp32 or bf16; the weights and bias are taken in fp32 and the sum is
fp32, rounded once to x's dtype, as the Pallas kernel computes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

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


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/conv1d.cu`` built and bound."""
    lib = _build.load("conv1d")
    lib.causal_conv1d.argtypes = [_P] * 4 + [_I] * 7 + [_P]
    lib.causal_conv1d.restype = ctypes.c_int
    lib.conv1d_error_string.argtypes = [ctypes.c_int]
    lib.conv1d_error_string.restype = ctypes.c_char_p
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
    """x (B, L, D), w (k, D), bias (D,) or None -> (B, L, D) in x's dtype;
    the kernel walks L in tiles of ``tile_l`` rows."""
    _check_shapes(x, w, bias, activation, tile_l)
    if on_cpu(x):
        return conv1d_plain(x, w, bias, activation)
    b, l, d = x.shape
    w32 = w.float().contiguous()
    b32 = None if bias is None else bias.float().contiguous()
    check_cuda(x, dtypes=X_DTYPES)
    check_cuda(w32, b32, dtypes=FP32)
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.causal_conv1d(
        ptr(x), ptr(w32), ptr(b32), ptr(out), b, l, d, w.shape[0], tile_l,
        ACT_CODES[activation], int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"causal_conv1d (k {w.shape[0]}, B {b}, L {l}, "
                           f"tile_l {tile_l}) did not launch: "
                           f"{lib.conv1d_error_string(err).decode()}")
    LAUNCHES["conv1d"] += 1
    return out
