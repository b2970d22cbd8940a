"""Griffin / RecurrentGemma recurrent block (arXiv:2402.19427).

Block:  x -> { gate branch: GeLU(W_y x) }
             { rec  branch: RG-LRU(conv1d(W_x x)) }
        out = W_o(gate * rec)

RG-LRU:  r_t = sigmoid(W_a u_t + b_a)          (recurrence gate)
         i_t = sigmoid(W_i u_t + b_i)          (input gate)
         log a_t = -c * softplus(Lambda) * r_t  (c = 8)
         h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Counterpart of ``repro.models.rglru``, on one device (its ``shard`` call
is dropped), with its names and parameter keys.  The gates run in fp32 as
the JAX package computes them; ``softplus`` is ``logaddexp(x, 0)``, JAX's
definition (``F.softplus`` would return x itself past its threshold of
20).  The JAX package runs the recurrence as ``jax.lax.associative_scan``;
here ``linear_scan`` applies the same combine ``(a, b) . (a', b') = (a'a,
a'b + b')`` in the same odd/even recursion, log2(L) levels of whole-tensor
products (no loop over time steps).

The temporal conv (width 4) runs the conv1d kernel
(``kernels.ops.convdk_causal_conv1d``, no activation, fp32 weights and
sums) when ``use_kernel``, else the plain oracle on the weights rounded to
the activations' dtype, as the JAX package chooses; decode always takes the
plain single-token update.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..kernels.common import resolve_device
from ..kernels.ops import convdk_causal_conv1d
from ..kernels.ref import causal_conv1d_ref, causal_conv1d_update_ref
from .common import dense, dense_def
from .param import P

_C = 8.0
_EPS = 1e-6


class RGLRUConfig(NamedTuple):
    d_model: int
    width: int            # lru width
    d_conv: int = 4
    use_kernel: bool = False


def rglru_def(cfg: RGLRUConfig) -> dict:
    d, w = cfg.d_model, cfg.width
    return {
        "in_x": dense_def(d, w),
        "in_y": dense_def(d, w),
        "conv": {"w": P((cfg.d_conv, w)), "b": P((w,), init="zeros")},
        "gate_a": dense_def(w, w),
        "gate_i": dense_def(w, w),
        "lam": P((w,), init="constant", scale=1.1),
        "out": dense_def(w, d),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it, at every x."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(params: dict, u: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, both fp32."""
    r = torch.sigmoid(dense(params["gate_a"], u).float())
    i = torch.sigmoid(dense(params["gate_i"], u).float())
    log_a = -_C * softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), _EPS))
    return a, beta * i * u.float()


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0: the inclusive
    scan of the combine above in ``jax.lax.associative_scan``'s odd/even
    recursion.  Adjacent pairs combine into a sequence of half the length,
    whose scan gives h at the odd positions; one more combine each gives
    the even ones.  log2(L) levels of whole-tensor calls, about 14 passes
    over (a, b)'s size in all."""
    n = a.shape[1]
    if n < 2:
        return b
    a0, a1 = a[:, 0:n - 1:2], a[:, 1::2]
    odd = linear_scan(a1 * a0, torch.addcmul(b[:, 1::2], a1,
                                             b[:, 0:n - 1:2]))
    even = torch.cat([b[:, :1], torch.addcmul(
        b[:, 2::2], a[:, 2::2], odd[:, :(n - 1) // 2])], dim=1)
    pairs = torch.stack([even[:, :n // 2], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n // 2:]], dim=1) if n % 2 else pairs


def rglru_scan(params: dict, u: torch.Tensor,
               init_h: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (B, L, W) -> (h (B, L, W) in u's dtype, final h (B, W) fp32)."""
    a, b = _gates(params, u)
    if init_h is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * init_h.float()[:, None],
                       b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    return h.to(u.dtype), h[:, -1]


def _conv(params: dict, u: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    w, bias = params["w"], params["b"]
    if use_kernel:
        return convdk_causal_conv1d(u, w, bias)
    return causal_conv1d_ref(u, w.to(u.dtype), bias.to(u.dtype))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu(approximate=True)


def rglru_block(params: dict, x: torch.Tensor,
                cfg: RGLRUConfig) -> torch.Tensor:
    """Full recurrent block (training / prefill).  x: (B, L, D)."""
    gate = _gelu(dense(params["in_y"], x))
    u = _conv(params["conv"], dense(params["in_x"], x), cfg.use_kernel)
    h, _ = rglru_scan(params, u)
    return dense(params["out"], gate * h)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class RGLRUState(NamedTuple):
    conv: torch.Tensor      # (B, d_conv-1, W), the cache dtype
    h: torch.Tensor         # (B, W) fp32


def init_rglru_state(batch: int, cfg: RGLRUConfig,
                     dtype: torch.dtype = torch.bfloat16,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> RGLRUState:
    """Zero decode state of one layer; ``device`` defaults to the card
    (``resolve_device``)."""
    device = resolve_device(device)
    return RGLRUState(
        conv=torch.zeros(batch, cfg.d_conv - 1, cfg.width, dtype=dtype,
                         device=device),
        h=torch.zeros(batch, cfg.width, dtype=torch.float32, device=device),
    )


def rglru_decode_step(params: dict, x_t: torch.Tensor, state: RGLRUState,
                      cfg: RGLRUConfig) -> Tuple[torch.Tensor, RGLRUState]:
    """One token.  x_t: (B, 1, D) -> (y (B, 1, D), new state).  O(1) in L."""
    gate = _gelu(dense(params["in_y"], x_t)[:, 0])
    u = dense(params["in_x"], x_t)[:, 0]
    conv = params["conv"]
    u, new_conv = causal_conv1d_update_ref(state.conv, u,
                                           conv["w"].to(u.dtype),
                                           conv["b"].to(u.dtype))
    a, b = _gates(params, u[:, None])
    h = a[:, 0] * state.h + b[:, 0]
    y = dense(params["out"], (gate * h.to(gate.dtype))[:, None])
    return y, RGLRUState(conv=new_conv, h=h)
