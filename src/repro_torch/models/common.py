"""Shared building blocks: RMSNorm, dense projections, rotary position
embeddings, activations, embeddings and the depthwise-separable block (the
MobileNet building block).

Counterpart of ``repro.models.common``:

* ``rmsnorm`` (fp32 inside, the input's dtype out), ``dense`` (the weight,
  and the bias where the definition has one, cast to the input's dtype on
  every call, as the JAX package writes it), ``embed`` / ``unembed`` /
  ``head_def``, with their ``*_def`` declarations;
* ``rope_freqs`` / ``apply_rope`` (split halves, fp32 angles, the input's
  dtype out) and ``act_fn`` (``"gelu"`` the tanh approximation, JAX's
  default, ``"gelu_exact"`` the erf form, ``"silu"``, ``"relu"``);
* ``softmax_cross_entropy``, the LM loss (fp32, mean or masked mean);
* ``separable_def`` declares one separable block's parameters and
  ``separable_block`` applies it, through the fused kernel
  (``kernels.convdk_fused``) or, with ``fused=False``, the staged pipeline
  (``kernels.ops``) that the JAX package selects with
  ``ConvKernelConfig.fused_separable``, or on a mesh through
  ``kernels.convdk_fused_separable_sharded``; it returns ``(y,
  out_layout)``, as ``models.mbconv``'s blocks do.  The tile comes from
  ``core.autotune.get_fused_schedule``.  The JAX block's ``cfg`` and
  ``pin`` are not ported: the caller passes ``fused`` and ``schedule``;
* ``mesh_route`` decides whether a block shards on a mesh, for the
  separable block and ``models.mbconv``'s.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.autotune import FusedSchedule, get_fused_schedule
from ..core.perfmodel import DEFAULT_LAYOUT, validate_layout
from ..kernels.convdk_fused import convdk_fused_separable
from ..kernels.convdk_sharded import (
    can_shard_fused,
    conv_mesh_shape,
    convdk_fused_separable_sharded,
)
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


def dense_def(d_in: int, d_out: int, bias: bool = False,
              scale: Optional[float] = None) -> dict:
    d = {"w": P((d_in, d_out), scale=scale)}
    if bias:
        d["b"] = P((d_out,), init="zeros")
    return d


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S) (broadcastable)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (D/2,)
    angles = positions[..., None].float() * freqs              # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
    "relu": F.relu,
}


def act_fn(name: str):
    return _ACTS[name]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean cross-entropy over valid positions: logits (..., V) in any
    dtype, taken in fp32; labels (...) integer; ``mask`` (...) weights the
    positions, the sum divided by max(mask.sum(), 1).

    The gold logit is a ``torch.gather``: it selects the same single value
    that the JAX package's one-hot masked reduction sums (every other term
    of that sum is an exact 0), so the loss is the same.  Pad logits are
    already -1e30 (``models.model._mask_pad_logits``)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


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


def mesh_route(mesh, x: torch.Tensor, c_grid: int, fused: bool,
               in_layout: str) -> Tuple[int, int, bool, str, torch.Tensor]:
    """(global batch, model factor, sharded?, effective in layout, x) of a
    block on ``mesh``: it shards where the global batch and its channel
    grid divide the factors, and an input arriving sharded to a block that
    does not shard is all-gathered first."""
    validate_layout(in_layout)
    if mesh is None:
        if in_layout != DEFAULT_LAYOUT:
            raise ValueError("a model-sharded input needs its mesh")
        return x.shape[0], 1, False, DEFAULT_LAYOUT, x
    dp, mp = conv_mesh_shape(mesh)
    b = x.shape[0] * dp
    sharded = fused and can_shard_fused(mesh, b, c_grid)
    if in_layout == "model_sharded" and not sharded:
        x = mesh.all_gather(x, "model", dim=-1)
        in_layout = DEFAULT_LAYOUT
    return b, mp, sharded, in_layout, x


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
    mesh=None,
    in_layout: str = DEFAULT_LAYOUT,
) -> Tuple[torch.Tensor, str]:
    """Apply one separable block, ``act(pw(dw_act(dw(x))))``; returns
    ``(y, out_layout)``.

    ``fused`` runs it as ONE kernel launch (one read of ``x``, one write
    of the output); otherwise the staged pipeline runs (row strips ->
    depthwise kernel -> device memory -> pointwise matmul).  The weights
    are cast to ``x``'s dtype, as in the JAX package.  The tile comes from
    ``schedule`` when the caller solved it, else from
    ``get_fused_schedule`` for this shape and partitioning.

    With a ``mesh``, ``x`` is this rank's batch slice, all of its channels
    or (``in_layout="model_sharded"``) the rank's slice of them.  The
    fused block shards where ``can_shard_fused`` allows, as the JAX
    block routes: c_out on "model" for a replicated arrival (no
    collective; the rank keeps its c_out slice), c_in for a model-sharded
    one (the pointwise partial reduced per the schedule's collective).
    ``out_layout`` is where the output's channels are: ``model_sharded``
    where the rank holds a slice of them (the replicated entry, or a
    psum_scatter exit, padded as ``shard_to_layout`` pads), else
    ``replicated``.  Where the block does not shard, a sharded arrival is
    all-gathered and the single-card route runs on the rank's batch.
    x: (B, H, W, C_in) NHWC -> (B, H', W', C_out).
    """
    w_dw, w_pw = params["dw"].to(x.dtype), params["pw"].to(x.dtype)
    c_out, k = w_pw.shape[1], w_dw.shape[0]
    mp = conv_mesh_shape(mesh)[1] if mesh is not None else 1
    c_grid = x.shape[-1] * mp if in_layout == "model_sharded" else c_out
    b, mp, sharded, in_layout, x = mesh_route(mesh, x, c_grid, fused,
                                              in_layout)
    _, h, w, c_in = x.shape
    if in_layout == "model_sharded":
        c_in *= mp
    if schedule is None:
        schedule = get_fused_schedule(
            b, h, w, c_in, c_out, k, stride, dtype_bytes=x.element_size(),
            mesh_shape=conv_mesh_shape(mesh) if sharded else (1, 1),
            in_layout=in_layout)
    if sharded:
        out = convdk_fused_separable_sharded(
            x, w_dw, w_pw, mesh=mesh, stride=stride, padding=padding,
            tile_h=schedule.tile_h, tile_w=schedule.tile_w, dw_act=dw_act,
            act=act, collective=schedule.collective, in_layout=in_layout)
        sliced = mp > 1 and (in_layout == DEFAULT_LAYOUT
                             or schedule.collective == "psum_scatter")
        return out, "model_sharded" if sliced else DEFAULT_LAYOUT
    if fused:
        out = convdk_fused_separable(
            x, w_dw, w_pw, stride=stride, padding=padding,
            tile_h=schedule.tile_h, tile_w=schedule.tile_w, dw_act=dw_act,
            act=act)
    else:
        out = convdk_separable_staged(
            x, w_dw, w_pw, stride=stride, padding=padding,
            tile_h=schedule.tile_h, dw_act=dw_act, act=act)
    return out, DEFAULT_LAYOUT
