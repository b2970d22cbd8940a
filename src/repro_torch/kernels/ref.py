"""Plain PyTorch oracles for the MBConv kernels (NHWC, JAX layouts).

Counterparts of ``repro.kernels.ref``: the ground truth the kernels and
the port's host glue are checked against.  Only torch primitives.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .common import spatial_pads


def _act_ref(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return x
    if act == "relu":
        return torch.clamp(x, min=0.0)
    if act == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if act == "silu":
        return x * torch.sigmoid(x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    if act == "hard_swish":
        return x * torch.clamp(x + 3.0, 0.0, 6.0) * (1.0 / 6.0)
    if act == "hard_sigmoid":
        return torch.clamp(x + 3.0, 0.0, 6.0) * (1.0 / 6.0)
    raise ValueError(f"unsupported activation: {act}")


def pad_nhwc(x: torch.Tensor, pads) -> torch.Tensor:
    """Zero-pad the H and W dims of an NHWC tensor by ((top, bottom),
    (left, right))."""
    (top, bottom), (left, right) = pads
    return F.pad(x, (0, 0, left, right, top, bottom))


def depthwise_valid(x: torch.Tensor, w: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """Unpadded depthwise conv.  x: (B, H, W, C) NHWC; w: (k_h, k_w, C)."""
    c = w.shape[-1]
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(2, 0, 1).unsqueeze(1),
                   stride=stride, groups=c)
    return out.permute(0, 2, 3, 1).contiguous()


def depthwise2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                    padding: str = "SAME") -> torch.Tensor:
    """Depthwise Conv2D oracle.  x: (B, H, W, C) NHWC; w: (k_h, k_w, C)."""
    k_h, k_w, _ = w.shape
    _, _, pads = spatial_pads(x.shape[1], x.shape[2], k_h, k_w, stride,
                              padding)
    return depthwise_valid(pad_nhwc(x, pads), w, stride)


def mbconv_ref(
    x: torch.Tensor,
    w_exp: torch.Tensor,
    w_dw: torch.Tensor,
    w_se1: Optional[torch.Tensor],
    b_se1: Optional[torch.Tensor],
    w_se2: Optional[torch.Tensor],
    b_se2: Optional[torch.Tensor],
    w_proj: torch.Tensor,
    stride: int = 1,
    padding: str = "SAME",
    exp_act: Optional[str] = "silu",
    dw_act: Optional[str] = "silu",
    se_act: Optional[str] = "silu",
    gate_act: Optional[str] = "sigmoid",
) -> torch.Tensor:
    """MBConv block oracle WITHOUT the residual add:

        expand 1x1 -> exp_act -> depthwise k x k / s -> dw_act
        -> SE (mean pool -> FC -> se_act -> FC -> gate_act, scaling the DW
           output; skipped when ``w_se1 is None``) -> project 1x1.

    Shapes as ``repro.kernels.ref.mbconv_ref``; all contractions in f32.
    The DW stage zero-pads the EXPANDED tensor, as the JAX oracle does.
    """
    e = _act_ref(x.float() @ w_exp.float(), exp_act)
    d = _act_ref(depthwise2d_ref(e, w_dw.float(), stride, padding), dw_act)
    if w_se1 is not None:
        pooled = d.mean(dim=(1, 2))
        s1 = _act_ref(pooled @ w_se1.float() + b_se1.float(), se_act)
        gate = _act_ref(s1 @ w_se2.float() + b_se2.float(), gate_act)
        d = d * gate[:, None, None, :]
    return (d @ w_proj.float()).to(x.dtype)
