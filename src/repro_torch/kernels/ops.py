"""The staged separable pipeline, the standalone depthwise op and the
causal conv1d op.

Counterpart of ``repro.kernels.ops``:

* ``stage_row_strips`` lays the padded input out as overlapping row
  strips, a PyTorch gather that WRITES the duplicated halo rows to device
  memory: the buffer traffic the paper's staged baseline pays and the
  fused kernel (``kernels.convdk_fused``) removes;
* ``convdk_depthwise2d`` runs the depthwise kernel (``kernels.convdk_dw``)
  over those strips;
* ``convdk_separable_staged`` is the staged baseline: the depthwise
  output round-trips device memory into a separate ``torch.matmul`` for
  the pointwise projection (a plain product, which the JAX package also
  leaves to XLA);
* ``stage_seq_strips`` is the JAX path's causal (B, L, D) -> strips
  staging step, kept for parity: the conv1d kernel reads the unstaged input
  and loads its own halo, so ``convdk_causal_conv1d`` never stages;
* ``convdk_causal_conv1d`` runs the causal conv1d kernel
  (``kernels.convdk_conv1d``), the Mamba-2 / RecurrentGemma stem.

``convdk_depthwise2d`` and ``convdk_causal_conv1d`` are differentiable:
when an operand requires grad they go through an autograd Function whose
backward is autograd through ``depthwise2d_ref`` / ``causal_conv1d_ref``,
as the JAX package's ``custom_vjp`` backwards are.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .common import needs_grad, spatial_pads, vjp_through
from .convdk_conv1d import conv1d
from .convdk_dw import dw2d
from .ref import _act_ref, causal_conv1d_ref, depthwise2d_ref, pad_nhwc


def stage_row_strips(x: torch.Tensor, k: int, stride: int,
                     tile_h: int) -> torch.Tensor:
    """(B, H_pad, W_pad, C) -> (B, n_th, (tile_h-1)*s + k, W_pad, C)
    strips, the last one zero-filled below the input."""
    h_pad = x.shape[1]
    in_rows = (tile_h - 1) * stride + k
    out_h = (h_pad - k) // stride + 1
    n_th = -(-out_h // tile_h)
    need = (n_th - 1) * tile_h * stride + in_rows
    if need > h_pad:
        x = F.pad(x, (0, 0, 0, 0, 0, need - h_pad))
    starts = torch.arange(n_th, device=x.device) * (tile_h * stride)
    idx = starts[:, None] + torch.arange(in_rows, device=x.device)[None, :]
    return x[:, idx]                                    # gather rows


def stage_seq_strips(x: torch.Tensor, k: int, tile_l: int) -> torch.Tensor:
    """(B, L, D) -> causal strips (B, n_tl, tile_l + k - 1, D): strip t
    holds the left-padded positions [t*tile_l - k + 1, (t+1)*tile_l)."""
    l = x.shape[1]
    n_tl = -(-l // tile_l)
    xp = F.pad(x, (0, 0, k - 1, n_tl * tile_l - l))
    starts = torch.arange(n_tl, device=x.device) * tile_l
    idx = starts[:, None] + torch.arange(tile_l + k - 1,
                                         device=x.device)[None, :]
    return xp[:, idx]


def _dw2d_impl(x: torch.Tensor, w: torch.Tensor, stride: int, padding: str,
               tile_h: int) -> torch.Tensor:
    b, h, w_in, c = x.shape
    k = w.shape[0]
    out_h, out_w, pads = spatial_pads(h, w_in, k, k, stride, padding)
    tile_h = max(1, min(tile_h, out_h))
    strips = stage_row_strips(pad_nhwc(x, pads), k, stride, tile_h)
    out = dw2d(strips, w, stride=stride, out_w=out_w, tile_h=tile_h)
    return out.reshape(b, -1, out_w, c)[:, :out_h]


class _DepthwiseFn(torch.autograd.Function):
    """``_dw2d_impl`` forward; backward through ``depthwise2d_ref``."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, tile_h):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding)
        return _dw2d_impl(x, w, stride, padding, tile_h)

    @staticmethod
    def backward(ctx, grad_out):
        stride, padding = ctx.conf

        def ref(x, w):
            return depthwise2d_ref(x, w, stride, padding)

        return (*vjp_through(ref, ctx.saved_tensors, grad_out,
                             ctx.needs_input_grad[:2]), None, None, None)


def convdk_depthwise2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                       padding: str = "SAME",
                       tile_h: int = 8) -> torch.Tensor:
    """Depthwise Conv2D through staged strips and the depthwise kernel.

    x: (B, H, W, C) NHWC; w: (k, k, C).  Returns (B, H', W', C).
    """
    if w.shape[0] != w.shape[1]:
        raise ValueError(f"square depthwise kernels only, got "
                         f"{tuple(w.shape[:2])}")
    if needs_grad(x, w):
        return _DepthwiseFn.apply(x, w, stride, padding, tile_h)
    return _dw2d_impl(x, w, stride, padding, tile_h)


def convdk_separable_staged(
    x: torch.Tensor,
    w_dw: torch.Tensor,
    w_pw: torch.Tensor,
    *,
    stride: int = 1,
    padding: str = "SAME",
    tile_h: int = 8,
    dw_act: Optional[str] = None,
    act: Optional[str] = None,
) -> torch.Tensor:
    """The STAGED two-kernel separable pipeline (the comparison baseline):
    strips -> depthwise kernel -> device memory -> dw_act -> pointwise
    matmul -> act, the double trip ``convdk_fused_separable`` fuses away.
    As the JAX route rounds: the depthwise output widened to fp32, dw_act,
    the matmul against fp32 ``w_pw`` and act in fp32, one rounding to
    ``x.dtype`` (every cast a no-op in fp32).
    """
    y = convdk_depthwise2d(x, w_dw, stride=stride, padding=padding,
                           tile_h=tile_h)
    z = torch.matmul(_act_ref(y.float(), dw_act), w_pw.float())
    return _act_ref(z, act).to(x.dtype)


def _conv1d_impl(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor], activation: Optional[str],
                 tile_l: int) -> torch.Tensor:
    return conv1d(x.contiguous(), w, bias, activation, tile_l)


class _CausalConv1dFn(torch.autograd.Function):
    """``_conv1d_impl`` forward; backward through ``causal_conv1d_ref``."""

    @staticmethod
    def forward(ctx, x, w, bias, activation, tile_l):
        ctx.save_for_backward(x, w, bias)
        ctx.activation = activation
        return _conv1d_impl(x, w, bias, activation, tile_l)

    @staticmethod
    def backward(ctx, grad_out):
        def ref(x, w, bias):
            return causal_conv1d_ref(x, w, bias, ctx.activation).to(x.dtype)

        return (*vjp_through(ref, ctx.saved_tensors, grad_out,
                             ctx.needs_input_grad[:3]), None, None)


def convdk_causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         activation: Optional[str] = None,
                         tile_l: int = 512) -> torch.Tensor:
    """Causal depthwise Conv1D (+ fused bias / SiLU) through the conv1d
    kernel.  x: (B, L, D); w: (k, D); bias: (D,) or None.  Returns
    (B, L, D) in x's dtype.  ``tile_l`` is the JAX API's L tile, checked
    and otherwise unused: the kernel's launch plan is the card's
    (``convdk_conv1d.conv1d_plan``)."""
    if needs_grad(x, w, bias):
        return _CausalConv1dFn.apply(x, w, bias, activation, tile_l)
    return _conv1d_impl(x, w, bias, activation, tile_l)
