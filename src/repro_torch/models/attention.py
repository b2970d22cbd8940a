"""Attention: MHA / GQA / MQA with RoPE, causal and sliding-window masks,
chunked online softmax for long context, and KV-cache decode.

Counterpart of ``repro.models.attention``, with its names and parameter
keys (``q``, ``k``, ``v``, ``o``).  Activations are (B, S, D); heads live
in (B, S, H, Dh) between the projections.  GQA groups the query heads by
KV head inside the score einsum, head ``h = kv_index * g + g_index`` (no
materialized repeat).  Scores and the softmax run in fp32 through
einsums, as the JAX package computes them; no library attention kernel is
called.

The sequence-parallel route (``_seq_shard_mesh``, ``_seq_parallel_sdpa``)
runs over a ``launch.mesh`` mesh: ``attention(..., mesh=mesh)`` with
``seq_shard`` set takes it where the JAX package's engages (a "model" axis
of M > 1 devices dividing S, and the KV heads not dividing M, so that the
heads cannot shard).  Each rank then holds its own activations (its batch
slice where the caller shards the batch over "data"), computes its S/M
query rows, with their positions, against the whole K/V, and one
all-gather over "model" puts the output's rows back in order.  Without a
mesh, or where the conditions fail, the route is a no-op, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..kernels.common import resolve_device
from ..launch.mesh import MODEL_AXIS
from .common import apply_rope, dense, dense_def

NEG_INF = -2.0e38


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    causal: bool = True
    window: Optional[int] = None       # sliding-window size (local attention)
    q_chunk: int = 2048
    kv_chunk: int = 1024
    # soft logit cap (Gemma-2-style); 0 disables
    logit_cap: float = 0.0
    seq_shard: bool = False


def attn_def(cfg: AttnConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "q": dense_def(d, h * hd, bias=cfg.qkv_bias),
        "k": dense_def(d, kv * hd, bias=cfg.qkv_bias),
        "v": dense_def(d, kv * hd, bias=cfg.qkv_bias),
        "o": dense_def(h * hd, d),
    }


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) fp32 additive mask bias from position vectors."""
    ok = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return _bias(ok)


def _bias(ok: torch.Tensor) -> torch.Tensor:
    return torch.zeros(ok.shape, device=ok.device).masked_fill_(~ok, NEG_INF)


def _cap(scores: torch.Tensor, logit_cap: float) -> torch.Tensor:
    if logit_cap > 0:
        return logit_cap * torch.tanh(scores / logit_cap)
    return scores


def _sdpa(q, k, v, bias, scale, logit_cap):
    """q (B,Sq,H,D), k (B,Sk,KV,D), v (B,Sk,KV,Dv) -> (B,Sq,H,Dv)."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    dv = v.shape[-1]
    qg = q.reshape(b, sq, kv, h // kv, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    scores = _cap(scores, logit_cap) + bias[None, None, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, dv).to(q.dtype)


def _pad_rows(t: torch.Tensor, n: int, value: float = 0) -> torch.Tensor:
    """``t`` with ``n`` rows of ``value`` appended along dim 1 (dim 0 of a
    position vector)."""
    if t.dim() == 1:
        return torch.cat([t, t.new_full((n,), value)])
    return torch.cat([t, t.new_full((t.shape[0], n) + t.shape[2:], value)],
                     dim=1)


def _chunked_sdpa(q, k, v, q_pos, k_pos, causal, window, scale, logit_cap,
                  q_chunk, kv_chunk):
    """Online softmax over KV chunks; peak memory O(Sq * kv_chunk).

    Padded query rows take position -1 and padded keys 2**30, so the causal
    mask kills them; rows that no key reaches are guarded by ``m_safe``.
    Every (q, kv) block runs, fully masked ones too, as the JAX package's
    static grid does (their contribution is exactly zero).  Supports
    d_v != d_qk.
    """
    b, sq, h, d = q.shape
    dv = v.shape[-1]
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    n_q = -(-sq // q_chunk)
    n_k = -(-sk // kv_chunk)
    q_pad = n_q * q_chunk - sq
    k_pad = n_k * kv_chunk - sk
    if q_pad:
        q, q_pos = _pad_rows(q, q_pad), _pad_rows(q_pos, q_pad, -1)
    if k_pad:
        k, v = _pad_rows(k, k_pad), _pad_rows(v, k_pad)
        k_pos = _pad_rows(k_pos, k_pad, 2 ** 30)

    qc = q.reshape(b, n_q, q_chunk, kv, g, d).float()
    kc = k.reshape(b, n_k, kv_chunk, kv, d).float()
    vc = v.reshape(b, n_k, kv_chunk, kv, dv).float()
    qp = q_pos.reshape(n_q, q_chunk)
    kp = k_pos.reshape(n_k, kv_chunk)

    outs = []
    for qi in range(n_q):
        qb, qpb = qc[:, qi], qp[qi]                    # (B,Qc,KV,G,D), (Qc,)
        acc = q.new_zeros((b, kv, g, q_chunk, dv), dtype=torch.float32)
        m = q.new_full((b, kv, g, q_chunk), NEG_INF, dtype=torch.float32)
        l = q.new_zeros((b, kv, g, q_chunk), dtype=torch.float32)
        for ki in range(n_k):
            kb, vb, kpb = kc[:, ki], vc[:, ki], kp[ki]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
            s = _cap(s, logit_cap) + _mask_bias(qpb, kpb, causal,
                                               window)[None, None, None]
            m_new = torch.maximum(m, s.amax(-1))
            # guard fully-masked rows (m_new = -inf) against NaN
            m_safe = m_new.clamp_min(-1e30)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(m.clamp_min(-1e30) - m_safe)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vb)
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]      # (B,KV,G,Qc,Dv)
        outs.append(out.permute(0, 3, 1, 2, 4))        # (B,Qc,KV,G,Dv)
    out = torch.cat(outs, dim=1).reshape(b, n_q * q_chunk, h, dv)
    return out[:, :sq].to(q.dtype)


def attention(params: dict, x: torch.Tensor, cfg: AttnConfig,
              positions: Optional[torch.Tensor] = None,
              use_chunked: Optional[bool] = None, mesh=None) -> torch.Tensor:
    """Self-attention over x (B, S, D); the chunked online softmax where
    ``use_chunked``, by default where S passes ``q_chunk``; on ``mesh``
    the sequence-parallel route where ``_seq_shard_mesh`` admits it."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = dense(params["q"], x).reshape(b, s, h, hd)
    k = dense(params["k"], x).reshape(b, s, kvh, hd)
    v = dense(params["v"], x).reshape(b, s, kvh, hd)
    q = apply_rope(q, positions[None, :], cfg.rope_theta)
    k = apply_rope(k, positions[None, :], cfg.rope_theta)

    scale = hd ** -0.5
    if use_chunked is None:
        use_chunked = s > cfg.q_chunk
    if _seq_shard_mesh(cfg, s, mesh) is not None:
        out = _seq_parallel_sdpa(mesh, q, k, v, positions, cfg, scale,
                                 use_chunked)
    elif use_chunked:
        out = _chunked_sdpa(q, k, v, positions, positions, cfg.causal,
                            cfg.window, scale, cfg.logit_cap,
                            cfg.q_chunk, cfg.kv_chunk)
    else:
        bias = _mask_bias(positions, positions, cfg.causal, cfg.window)
        out = _sdpa(q, k, v, bias, scale, cfg.logit_cap)
    return dense(params["o"], out.reshape(b, s, h * hd))


def _seq_shard_mesh(cfg: AttnConfig, s: int, mesh):
    """``mesh`` where sequence-parallel attention engages, else None: JAX's
    conditions on its mesh's "model" axis."""
    if not cfg.seq_shard or mesh is None:
        return None
    m = mesh.size(MODEL_AXIS)
    if m <= 1 or s % m != 0:
        return None
    if cfg.n_kv_heads % m == 0:
        return None   # heads shard fine; no need for SP
    return mesh


def _seq_parallel_sdpa(mesh, q, k, v, positions, cfg: AttnConfig, scale,
                       use_chunked):
    """Context parallelism: this "model" rank computes its s/M query rows
    (``Mesh.chunk`` of q and of the positions) against the whole K/V; the
    causal and window masks follow the rows' positions, and the chunked
    choice is made on the local length, as in JAX.  One all-gather of the
    (B, s/M, H, Dv) rows over "model" returns the whole output."""
    s_loc = q.shape[1] // mesh.size(MODEL_AXIS)
    q_l = mesh.chunk(q, MODEL_AXIS, dim=1)
    pos_l = mesh.chunk(positions, MODEL_AXIS, dim=0)
    if use_chunked and s_loc > cfg.q_chunk:
        out = _chunked_sdpa(q_l, k, v, pos_l, positions, cfg.causal,
                            cfg.window, scale, cfg.logit_cap, cfg.q_chunk,
                            cfg.kv_chunk)
    else:
        bias = _mask_bias(pos_l, positions, cfg.causal, cfg.window)
        out = _sdpa(q_l, k, v, bias, scale, cfg.logit_cap)
    return mesh.all_gather(out, MODEL_AXIS, dim=1)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Dense KV cache; for windowed attention a RING buffer of size
    ``window`` (slot = pos % window)."""

    k: torch.Tensor         # (B, S_cache, KV, Dh)
    v: torch.Tensor
    slot_pos: torch.Tensor  # (S_cache,) int32: position held per slot (-1 empty)
    pos: torch.Tensor       # () int32: the next write position (whole batch)


def init_kv_cache(batch: int, s_max: int, cfg: AttnConfig,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> KVCache:
    """An empty cache on ``device`` (default the card, raising without
    one)."""
    device = resolve_device(device)
    s_cache = min(s_max, cfg.window) if cfg.window else s_max
    shape = (batch, s_cache, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        slot_pos=torch.full((s_cache,), -1, dtype=torch.int32, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def decode_attention(params: dict, x_t: torch.Tensor, cache: KVCache,
                     cfg: AttnConfig) -> Tuple[torch.Tensor, KVCache]:
    """One-token step.  x_t: (B, 1, D).  Returns (out (B, 1, D), new cache).

    Dense cache: write slot = pos; ring cache (windowed): slot = pos % W.
    The slot is clamped into the cache, as JAX's ``dynamic_update_slice``
    clamps its start.  ``pos`` is one position for the whole batch, so a
    left-padded prompt feeds its pad tokens through the cache, as in the
    JAX package.
    """
    b = x_t.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = cache.pos
    q = dense(params["q"], x_t).reshape(b, 1, h, hd)
    k = dense(params["k"], x_t).reshape(b, 1, kvh, hd)
    v = dense(params["v"], x_t).reshape(b, 1, kvh, hd)
    posv = pos.reshape(1, 1).expand(b, 1)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)

    s_cache = cache.k.shape[1]
    slot = pos % s_cache if cfg.window else pos
    slot = slot.clamp(0, s_cache - 1).reshape(1).long()
    k_all = cache.k.index_copy(1, slot, k.to(cache.k.dtype))
    v_all = cache.v.index_copy(1, slot, v.to(cache.v.dtype))
    slot_pos = cache.slot_pos.index_copy(0, slot, pos.reshape(1))

    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if cfg.window is not None:
        valid &= slot_pos > pos - cfg.window
    bias = _bias(valid)                                 # (S_cache,)

    qg = q.reshape(b, 1, kvh, h // kvh, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k_all.float()) * hd ** -0.5
    probs = torch.softmax(_cap(scores, cfg.logit_cap)
                          + bias[None, None, None, None], dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_all.float())
    out = out.reshape(b, 1, h * hd).to(x_t.dtype)
    y = dense(params["o"], out)
    return y, KVCache(k=k_all, v=v_all, slot_pos=slot_pos, pos=pos + 1)
