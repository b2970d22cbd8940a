"""Shared building blocks: RMSNorm, dense projections, embeddings and the
depthwise-separable block (the MobileNet building block).

Counterpart of ``repro.models.common``:

* ``rmsnorm`` (fp32 inside, the input's dtype out), ``dense`` (the weight
  cast to the input's dtype on every call, as the JAX package writes it),
  ``embed`` / ``unembed`` / ``head_def``, with their ``*_def``
  declarations;
* ``separable_def`` declares one separable block's parameters and
  ``separable_block`` applies it, through the fused kernel
  (``kernels.convdk_fused``) or, with ``fused=False``, the staged pipeline
  (``kernels.ops``) that the JAX package selects with
  ``ConvKernelConfig.fused_separable``.  The tile comes from
  ``core.autotune.get_fused_schedule``.  Single device: the mesh, the
  schedule pin and the layouts of the JAX block are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.autotune import FusedSchedule, get_fused_schedule
from ..kernels.convdk_fused import convdk_fused_separable
from ..kernels.ops import convdk_separable_staged
from .param import P


def rmsnorm_def(d: int) -> dict:
    return {"scale": P((d,), init="ones")}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dtype)


def dense_def(d_in: int, d_out: int) -> dict:
    return {"w": P((d_in, d_out))}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype)


def embed_def(vocab: int, d: int) -> dict:
    return {"table": P((vocab, d), init="embed")}


def embed(params: dict, tokens: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    # the rows, then the cast: the same values as the JAX package's cast
    # of the whole table, then the rows
    return params["table"][tokens.long()].to(dtype)


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits via the (possibly tied) embedding table."""
    return x @ params["table"].to(x.dtype).T


def head_def(d: int, vocab: int) -> dict:
    return {"w": P((d, vocab))}


def separable_def(c_in: int, c_out: int, k: int = 3) -> dict:
    """Params of one depthwise-separable block: k x k DW taps + 1x1 PW."""
    return {"dw": P((k, k, c_in)), "pw": P((c_in, c_out), scale=2.0)}


def separable_block(
    x: torch.Tensor,
    params: dict,
    *,
    stride: int = 1,
    padding: str = "SAME",
    dw_act: Optional[str] = "relu",
    act: Optional[str] = "relu",
    fused: bool = True,
    schedule: Optional[FusedSchedule] = None,
) -> torch.Tensor:
    """Apply one separable block: ``act(pw(dw_act(dw(x))))``.

    ``fused`` runs it as ONE kernel launch (one read of ``x``, one write
    of the output); otherwise the staged pipeline runs (row strips ->
    depthwise kernel -> device memory -> pointwise matmul).  The tile comes
    from ``schedule`` when the caller solved it, else from
    ``get_fused_schedule`` for this shape.
    x: (B, H, W, C_in) NHWC -> (B, H', W', C_out).
    """
    w_dw, w_pw = params["dw"], params["pw"]
    if schedule is None:
        b, h, w, c_in = x.shape
        schedule = get_fused_schedule(b, h, w, c_in, w_pw.shape[1],
                                      w_dw.shape[0], stride,
                                      dtype_bytes=x.element_size())
    if fused:
        return convdk_fused_separable(
            x, w_dw, w_pw, stride=stride, padding=padding,
            tile_h=schedule.tile_h, tile_w=schedule.tile_w, dw_act=dw_act,
            act=act)
    return convdk_separable_staged(
        x, w_dw, w_pw, stride=stride, padding=padding,
        tile_h=schedule.tile_h, dw_act=dw_act, act=act)
