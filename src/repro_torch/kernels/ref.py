"""Plain PyTorch oracles for the separable, MBConv, Fused-MBConv and causal
conv1d kernels (NHWC and (B, L, D), JAX layouts).

Counterparts of ``repro.kernels.ref``: the ground truth the kernels and
the port's host glue are checked against.  Only torch primitives.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def separable_ref(x: torch.Tensor, w_dw: torch.Tensor, w_pw: torch.Tensor,
                  stride: int = 1, padding: str = "SAME",
                  dw_act: Optional[str] = None,
                  act: Optional[str] = None) -> torch.Tensor:
    """Depthwise-separable block oracle: DW conv -> dw_act -> 1x1 PW -> act.

    x: (B, H, W, C_in); w_dw: (k_h, k_w, C_in); w_pw: (C_in, C_out).  The PW
    contraction in f32, as ``repro.kernels.ref.separable_ref``.
    """
    y = _act_ref(depthwise2d_ref(x, w_dw, stride, padding).float(), dw_act)
    return _act_ref(y @ w_pw.float(), act).to(x.dtype)


def mbconv_ref(
    x: torch.Tensor,
    w_exp: Optional[torch.Tensor],
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
    ``w_exp=None`` is the identity expand of expansion-ratio-1 blocks.  The
    DW stage zero-pads the EXPANDED tensor, as the JAX oracle does.
    """
    e = x.float() if w_exp is None else x.float() @ w_exp.float()
    e = _act_ref(e, exp_act)
    d = _act_ref(depthwise2d_ref(e, w_dw.float(), stride, padding), dw_act)
    if w_se1 is not None:
        pooled = d.mean(dim=(1, 2))
        s1 = _act_ref(pooled @ w_se1.float() + b_se1.float(), se_act)
        gate = _act_ref(s1 @ w_se2.float() + b_se2.float(), gate_act)
        d = d * gate[:, None, None, :]
    return (d @ w_proj.float()).to(x.dtype)


def fusedmb_ref(x: torch.Tensor, w_conv: torch.Tensor, w_proj: torch.Tensor,
                stride: int = 1, padding: str = "SAME",
                act: Optional[str] = "silu") -> torch.Tensor:
    """Fused-MBConv (EfficientNet-V2) block oracle WITHOUT the residual:

        dense k x k / s conv (C_in -> C_mid) -> act -> project 1x1.

    x: (B, H, W, C_in) NHWC; w_conv: (k, k, C_in, C_mid) HWIO; w_proj:
    (C_mid, C_out).  SAME pads as ``spatial_pads`` (extra pad bottom/right);
    all contractions in f32, as ``repro.kernels.ref.fusedmb_ref``.
    """
    k_h, k_w = w_conv.shape[:2]
    _, _, pads = spatial_pads(x.shape[1], x.shape[2], k_h, k_w, stride,
                              padding)
    xp = pad_nhwc(x.float(), pads).permute(0, 3, 1, 2)
    e = F.conv2d(xp, w_conv.float().permute(3, 2, 0, 1), stride=stride)
    e = _act_ref(e.permute(0, 2, 3, 1), act)
    return (e @ w_proj.float()).to(x.dtype)


def causal_conv1d_ref(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      activation: Optional[str] = None) -> torch.Tensor:
    """Causal depthwise Conv1D oracle (the Mamba-2 / RecurrentGemma stem).

    x: (B, L, D); w: (k, D); out[t] = sum_i w[i] * x[t - k + 1 + i].  The
    dtypes promote as in ``repro.kernels.ref.causal_conv1d_ref``: with x and
    w in bf16 every partial sum rounds to bf16; with fp32 w the result is
    fp32.
    """
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + l, :] * w[i]
    if bias is not None:
        out = out + bias
    if activation == "silu":
        out = out * torch.sigmoid(out)
    return out


def causal_conv1d_update_ref(
    state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
    bias: Optional[torch.Tensor] = None, activation: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token decode step.  state: (B, k-1, D) last inputs; x_t:
    (B, D).  Returns (y_t, new_state)."""
    window = torch.cat([state, x_t[:, None, :]], dim=1)       # (B, k, D)
    dtype = torch.promote_types(window.dtype, w.dtype)       # as jnp.einsum
    y = torch.einsum("bkd,kd->bd", window.to(dtype), w.to(dtype))
    if bias is not None:
        y = y + bias
    if activation == "silu":
        y = y * torch.sigmoid(y)
    return y, window[:, 1:, :]
