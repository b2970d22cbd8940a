"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Counterpart of ``repro.models.mla``, with its names and parameter keys.
The KV state is compressed into a ``kv_lora``-dim latent ``c_kv`` plus one
shared RoPE key; queries go through a ``q_lora`` bottleneck.  The decode
cache holds only (c_kv, k_rope), the latent cache.  Decode takes the
absorbed form (W_uk folded into the query, W_uv into the output, so a step
never expands the latents to per-head K/V) or the expanded one, each in
fp32 einsums as the JAX package writes them.

The full-sequence form expands the latents and folds the two-part score
(no-RoPE + shared RoPE) into one attention of [q_nope | q_rope] against
[k_nope | broadcast k_rope] (d_qk = d_nope + d_rope, d_v = head_dim),
through ``models.attention``'s dense ``_sdpa`` or, past ``q_chunk``, its
chunked online softmax.  ``use_chunked`` (not in JAX) forces either one,
as ``attention`` takes it; by default the choice is JAX's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..kernels.common import resolve_device
from .attention import _bias, _chunked_sdpa, _mask_bias, _sdpa
from .common import apply_rope, dense, dense_def, rmsnorm, rmsnorm_def
from .param import P


class MLAConfig(NamedTuple):
    d_model: int
    n_heads: int
    q_lora: int
    kv_lora: int
    d_nope: int          # per-head non-rotary dim
    d_rope: int          # rotary dim (shared key)
    d_v: int             # per-head value dim
    rope_theta: float = 10000.0
    q_chunk: int = 2048
    kv_chunk: int = 1024


def mla_def(cfg: MLAConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dq = cfg.d_nope + cfg.d_rope
    return {
        "dq": dense_def(d, cfg.q_lora),
        "q_norm": rmsnorm_def(cfg.q_lora),
        "uq": dense_def(cfg.q_lora, h * dq),
        "dkv": dense_def(d, cfg.kv_lora),
        "kv_norm": rmsnorm_def(cfg.kv_lora),
        "kr": dense_def(d, cfg.d_rope),
        "uk": P((cfg.kv_lora, h, cfg.d_nope)),   # ("lora", "heads", None)
        "uv": P((cfg.kv_lora, h, cfg.d_v)),      # ("lora", "heads", None)
        "o": dense_def(h * cfg.d_v, d),
    }


def _project_q(params, x, cfg: MLAConfig, positions):
    b, s, _ = x.shape
    q = dense(params["uq"], rmsnorm(params["q_norm"], dense(params["dq"], x)))
    q = q.reshape(b, s, cfg.n_heads, cfg.d_nope + cfg.d_rope)
    q_nope, q_rope = q[..., :cfg.d_nope], q[..., cfg.d_nope:]
    q_rope = apply_rope(q_rope, positions[None, :], cfg.rope_theta)
    return q_nope, q_rope


def _project_kv_latent(params, x, cfg: MLAConfig, positions):
    c_kv = rmsnorm(params["kv_norm"], dense(params["dkv"], x))   # (B,S,L)
    k_rope = dense(params["kr"], x)[:, :, None, :]               # (B,S,1,dr)
    k_rope = apply_rope(k_rope, positions[None, :], cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_attention(params: dict, x: torch.Tensor, cfg: MLAConfig,
                  positions: Optional[torch.Tensor] = None,
                  use_chunked: Optional[bool] = None) -> torch.Tensor:
    """Full-sequence (training / prefill) MLA over x (B, S, D): the
    chunked online softmax where ``use_chunked``, by default where S
    passes ``q_chunk``."""
    b, s, _ = x.shape
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q_nope, q_rope = _project_q(params, x, cfg, positions)
    c_kv, k_rope = _project_kv_latent(params, x, cfg, positions)

    # the latents expanded (the absorbed form is decode-only)
    k_nope = torch.einsum("bsl,lhd->bshd", c_kv, params["uk"].to(x.dtype))
    v = torch.einsum("bsl,lhd->bshd", c_kv, params["uv"].to(x.dtype))
    q_cat = torch.cat([q_nope, q_rope], dim=-1)                 # (B,S,H,dn+dr)
    k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, cfg.d_rope)], dim=-1)
    scale = (cfg.d_nope + cfg.d_rope) ** -0.5
    if use_chunked is None:
        use_chunked = s > cfg.q_chunk
    if use_chunked:
        out = _chunked_sdpa(q_cat, k_cat, v, positions, positions, True,
                            None, scale, 0.0, cfg.q_chunk, cfg.kv_chunk)
    else:
        bias = _mask_bias(positions, positions, True, None)
        out = _sdpa(q_cat, k_cat, v, bias, scale, 0.0)
    out = out.reshape(b, s, h * cfg.d_v).to(x.dtype)
    return dense(params["o"], out)


# ---------------------------------------------------------------------------
# latent-cache decode
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    c_kv: torch.Tensor      # (B, S_max, kv_lora)
    k_rope: torch.Tensor    # (B, S_max, d_rope)
    pos: torch.Tensor       # () int32: the next write position


def init_mla_cache(batch: int, s_max: int, cfg: MLAConfig,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> MLACache:
    """An empty latent cache on ``device`` (default the card, raising
    without one)."""
    device = resolve_device(device)
    return MLACache(
        c_kv=torch.zeros((batch, s_max, cfg.kv_lora), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, s_max, cfg.d_rope), dtype=dtype,
                           device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def mla_decode(params: dict, x_t: torch.Tensor, cache: MLACache,
               cfg: MLAConfig, absorb: bool = True
               ) -> Tuple[torch.Tensor, MLACache]:
    """One-token MLA step with the latent cache.  x_t: (B, 1, D).  The
    write slot is clamped into the cache, as JAX's ``dynamic_update_slice``
    clamps its start."""
    b = x_t.shape[0]
    h = cfg.n_heads
    pos = cache.pos
    posv = pos.reshape(1)
    q_nope, q_rope = _project_q(params, x_t, cfg, posv)
    c_t, kr_t = _project_kv_latent(params, x_t, cfg, posv)

    s_max = cache.c_kv.shape[1]
    slot = pos.clamp(0, s_max - 1).reshape(1).long()
    c_all = cache.c_kv.index_copy(1, slot, c_t.to(cache.c_kv.dtype))
    kr_all = cache.k_rope.index_copy(1, slot, kr_t.to(cache.k_rope.dtype))

    bias = _bias(torch.arange(s_max, device=pos.device) <= pos)   # (S_max,)
    scale = (cfg.d_nope + cfg.d_rope) ** -0.5
    uk, uv = params["uk"].float(), params["uv"].float()
    c32, kr32 = c_all.float(), kr_all.float()
    if absorb:
        # W_uk folded into q: (B,1,H,dn) x (L,H,dn) -> (B,H,L)
        q_abs = torch.einsum("bqhd,lhd->bhl", q_nope.float(), uk)
        s_lat = torch.einsum("bhl,bsl->bhs", q_abs, c32)
        s_rope = torch.einsum("bqhd,bsd->bhs", q_rope.float(), kr32)
        probs = torch.softmax((s_lat + s_rope) * scale + bias, dim=-1)
        o_lat = torch.einsum("bhs,bsl->bhl", probs, c32)
        out = torch.einsum("bhl,lhd->bhd", o_lat, uv)
    else:
        k_nope = torch.einsum("bsl,lhd->bshd", c32, uk)
        v = torch.einsum("bsl,lhd->bshd", c32, uv)
        s_n = torch.einsum("bqhd,bshd->bhs", q_nope.float(), k_nope)
        s_r = torch.einsum("bqhd,bsd->bhs", q_rope.float(), kr32)
        probs = torch.softmax((s_n + s_r) * scale + bias, dim=-1)
        out = torch.einsum("bhs,bshd->bhd", probs, v)

    out = out.reshape(b, 1, h * cfg.d_v).to(x_t.dtype)
    y = dense(params["o"], out)
    return y, MLACache(c_kv=c_all, k_rope=kr_all, pos=pos + 1)
