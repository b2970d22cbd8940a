"""Model assembly of the language-model families: the config, the parameter
tree, the full-sequence forward and the single-token decode step.

Counterpart of ``repro.models.model``.  ``ModelConfig`` carries every field
of the JAX package's, so its configs copy over unchanged.  The ported
families are ``"ssm"`` (Mamba-2: a stack of SSD layers, ``models.ssd``),
``"dense"`` (decoder LMs: attention and an FFN per layer,
``models.attention`` and ``models.ffn``), ``"hybrid"`` (RecurrentGemma:
``"R"`` layers of an RG-LRU block and an FFN, ``models.rglru``, between
``"A"`` layers of local attention over ``window`` positions, whose decode
caches are rings of ``window`` slots) and ``"moe"`` (Granite-MoE,
DeepSeek-V2: attention and a mixture of experts per layer,
``models.moe``, with shared experts as an FFN beside it where
``n_shared_experts`` is set, and dense FFN layers for the first
``n_dense_prefix``); ``use_mla`` puts Multi-head Latent Attention
(``models.mla``, its latent caches stacked per layer as the KV caches are)
in place of attention.  The encoder and the VLM raise
``NotImplementedError`` (ROADMAP A items 12.4.3-12.4.4).

Per-layer parameters are stacked on a leading layer axis (the key
``"stack"``; the block's layers ``"0_S"``, ``"0_A"``, or the hybrid
pattern's ``"0_R"``, ``"1_R"``, ``"2_A"``), the JAX package's
scan-over-layers layout, so its param trees carry over key for key; a
hybrid stack's layers past the last whole pattern block are a list under
``"rem"``, and the dense prefix a list under ``"prefix"``, both unrolled,
as in JAX.  The decode state is stacked the same way
(the KV caches' positions one per layer).  The JAX ``lax.scan`` over the
stack becomes a Python loop that indexes the stacked tensors layer by
layer (views, no copies; a stacked leaf may also come as a list of its
layers, as ``grad_aliases`` makes it for the backward).  With ``remat`` each
pattern block of the stack (the JAX scan body) runs under
``torch.utils.checkpoint`` while grad is enabled, so the backward
recomputes its activations from the block's input, as ``jax.checkpoint``
does; the prefix and remainder layers are not rematerialized, as in JAX.
It changes no value.  ``scan_layers`` has no effect: the stack is a Python
loop either way.

``forward`` takes a ``launch.mesh`` mesh for the attention and MoE layers:
with ``seq_shard_attn`` the attention layers run the sequence-parallel
route where JAX's would engage (``models.attention``), and the MoE layers
run expert-parallel over a "model" axis of more than one rank
(``models.moe``); the rest of the model runs unsharded on each rank's
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.common import resolve_device
from . import attention as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssd as ssd_mod
from .common import (
    dense, embed, embed_def, head_def, rmsnorm, rmsnorm_def, unembed,
)
from .ffn import ffn, ffn_def
from .param import _leaves, _map, stack_defs

NOT_PORTED = ("not ported yet (ROADMAP A item 12.4: the encoder, 12.4.3, "
              "and the VLM, 12.4.4)")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"   # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 256
    vocab: int = 256
    act: str = "silu"
    glu: bool = True
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma-style sqrt(d) embedding scale
    logit_cap: float = 0.0
    # moe
    n_experts: int = 0
    n_experts_pad: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    n_dense_prefix: int = 0        # leading layers with dense FFN (deepseek)
    capacity_factor: float = 1.25
    # mla
    use_mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    d_nope: int = 0
    d_rope: int = 0
    # ssm
    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssd_chunk: int = 256
    # hybrid
    window: int = 0
    pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    # vlm
    n_img_tokens: int = 0
    vision_stem: bool = False
    vision_stem_c0: int = 32
    vision_stem_blocks: int = 2
    vision_stem_arch: str = "separable"
    # execution
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    use_convdk_kernel: bool = False
    q_chunk: int = 2048
    kv_chunk: int = 1024
    mla_absorb: bool = True
    vocab_pad_multiple: int = 0    # pad vocab so logits shard on "model"
    seq_shard_attn: bool = False
    seq_shard_resid: bool = False

    # ---- derived ----
    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m if m else self.vocab

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssd_heads(self) -> int:
        return self.d_inner // 64 if self.family == "ssm" else 0

    def attn_cfg(self, window: Optional[int] = None) -> attn_mod.AttnConfig:
        return attn_mod.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta, qkv_bias=self.qkv_bias,
            causal=self.family != "encoder",
            window=window, q_chunk=self.q_chunk, kv_chunk=self.kv_chunk,
            logit_cap=self.logit_cap, seq_shard=self.seq_shard_attn,
        )

    def mla_cfg(self) -> mla_mod.MLAConfig:
        return mla_mod.MLAConfig(
            d_model=self.d_model, n_heads=self.n_heads, q_lora=self.q_lora,
            kv_lora=self.kv_lora, d_nope=self.d_nope, d_rope=self.d_rope,
            d_v=self.head_dim, rope_theta=self.rope_theta,
            q_chunk=self.q_chunk, kv_chunk=self.kv_chunk,
        )

    def moe_cfg(self) -> moe_mod.MoEConfig:
        return moe_mod.MoEConfig(
            d_model=self.d_model, n_experts=self.n_experts,
            n_experts_pad=self.n_experts_pad or self.n_experts,
            top_k=self.top_k, d_ff=self.d_ff_expert, act=self.act,
            capacity_factor=self.capacity_factor,
        )

    def ssd_cfg(self) -> ssd_mod.SSDConfig:
        return ssd_mod.SSDConfig(
            d_model=self.d_model, d_inner=self.d_inner,
            n_heads=self.d_inner // 64, head_dim=64, d_state=self.d_state,
            n_groups=1, d_conv=self.d_conv, chunk=self.ssd_chunk,
            use_kernel=self.use_convdk_kernel,
        )

    def rglru_cfg(self) -> rglru_mod.RGLRUConfig:
        return rglru_mod.RGLRUConfig(
            d_model=self.d_model, width=self.lru_width or self.d_model,
            d_conv=self.d_conv, use_kernel=self.use_convdk_kernel,
        )

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind sequence, e.g. ('A',)*n or ('R','R','A')*m."""
        if self.family == "hybrid":
            pat = self.pattern or ("R", "R", "A")
            reps = -(-self.n_layers // len(pat))
            return (pat * reps)[: self.n_layers]
        if self.family == "ssm":
            return ("S",) * self.n_layers
        return ("A",) * self.n_layers


PORTED = ("ssm", "dense", "hybrid", "moe")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is {NOT_PORTED}; the port "
            f"runs families {', '.join(map(repr, PORTED))}")


# ---------------------------------------------------------------------------
# per-layer definitions: "S" an SSD layer, "R" an RG-LRU block + FFN, "A"
# attention (or MLA) + an FFN (or a mixture of experts, where ``moe``)
# ---------------------------------------------------------------------------

def _layer_def(cfg: ModelConfig, kind: str, moe: bool) -> dict:
    d = cfg.d_model
    if kind == "S":
        return {"norm": rmsnorm_def(d), "ssd": ssd_mod.ssd_def(cfg.ssd_cfg())}
    if kind == "R":
        return {"norm": rmsnorm_def(d),
                "rec": rglru_mod.rglru_def(cfg.rglru_cfg()),
                "ln2": rmsnorm_def(d),
                "ffn": ffn_def(d, cfg.d_ff, cfg.act, cfg.glu)}
    p: Dict[str, Any] = {"ln1": rmsnorm_def(d)}
    if cfg.use_mla:
        p["attn"] = mla_mod.mla_def(cfg.mla_cfg())
    else:
        p["attn"] = attn_mod.attn_def(cfg.attn_cfg())
    p["ln2"] = rmsnorm_def(d)
    if moe:
        p["moe"] = moe_mod.moe_def(cfg.moe_cfg())
        if cfg.n_shared_experts:
            p["shared"] = ffn_def(d, cfg.n_shared_experts * cfg.d_ff_expert,
                                  cfg.act, cfg.glu)
    else:
        p["ffn"] = ffn_def(d, cfg.d_ff, cfg.act, cfg.glu)
    return p


def _window(cfg: ModelConfig) -> Optional[int]:
    """The local-attention window of the hybrid family's "A" layers."""
    return cfg.window if cfg.family == "hybrid" and cfg.window else None


def _apply_layer(lp: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                 positions: torch.Tensor, use_chunked: Optional[bool] = None,
                 mesh=None) -> torch.Tensor:
    if kind == "S":
        return x + ssd_mod.ssd_block(lp["ssd"], rmsnorm(lp["norm"], x),
                                     cfg.ssd_cfg())
    if kind == "R":
        h = x + rglru_mod.rglru_block(lp["rec"], rmsnorm(lp["norm"], x),
                                      cfg.rglru_cfg())
        return h + ffn(lp["ffn"], rmsnorm(lp["ln2"], h), cfg.act)
    h = rmsnorm(lp["ln1"], x)
    if cfg.use_mla:
        h = mla_mod.mla_attention(lp["attn"], h, cfg.mla_cfg(), positions,
                                  use_chunked)
    else:
        h = attn_mod.attention(lp["attn"], h, cfg.attn_cfg(_window(cfg)),
                               positions, use_chunked, mesh=mesh)
    x = x + h
    return x + _channel_mix(lp, rmsnorm(lp["ln2"], x), cfg, mesh)


def _channel_mix(lp: dict, h: torch.Tensor, cfg: ModelConfig,
                 mesh=None) -> torch.Tensor:
    """An "A" layer's FFN, or its mixture of experts plus the shared
    experts' FFN where the layer has them."""
    if "moe" not in lp:
        return ffn(lp["ffn"], h, cfg.act)
    y = moe_mod.moe_apply(lp["moe"], h, cfg.moe_cfg(), mesh=mesh)
    if "shared" in lp:
        y = y + ffn(lp["shared"], h, cfg.act)
    return y


def _layer_groups(cfg: ModelConfig):
    """(prefix kinds, unrolled; the stacked block's kinds; the block count;
    the remainder's kinds, unrolled): the JAX package's split.  A hybrid
    stack's block is its pattern, the layers past the last whole block the
    remainder; otherwise the block is one layer and no remainder exists."""
    kinds = cfg.layer_kinds()
    prefix = kinds[:cfg.n_dense_prefix]
    rest = kinds[cfg.n_dense_prefix:]
    if cfg.family == "hybrid":
        pat = cfg.pattern or ("R", "R", "A")
        n_blocks = len(rest) // len(pat)
        return prefix, pat, n_blocks, rest[n_blocks * len(pat):]
    return prefix, (rest[0],) if rest else (), len(rest), ()


def _block_key(i: int, kind: str) -> str:
    return f"{i}_{kind}"


def model_def(cfg: ModelConfig) -> dict:
    _require_ported(cfg)
    p: Dict[str, Any] = {"embed": embed_def(cfg.padded_vocab, cfg.d_model)}
    prefix, pat, n_blocks, rem = _layer_groups(cfg)
    moe = cfg.family == "moe"
    if prefix:       # the dense prefix
        p["prefix"] = [_layer_def(cfg, k, moe=False) for k in prefix]
    if n_blocks:
        p["stack"] = stack_defs({_block_key(i, k): _layer_def(cfg, k, moe)
                                 for i, k in enumerate(pat)}, n_blocks)
    if rem:
        p["rem"] = [_layer_def(cfg, k, moe) for k in rem]
    p["final_norm"] = rmsnorm_def(cfg.d_model)
    if not cfg.tie_embeddings:
        p["head"] = head_def(cfg.d_model, cfg.padded_vocab)
    return p


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree: views of every leaf (element ``i``
    of a leaf given as the list of its layers)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):          # a NamedTuple of state tensors
        return type(tree)(*(_index(v, i) for v in tree))
    return tree[i]


def grad_aliases(params: dict, grads: dict) -> dict:
    """Aliases of ``params`` (the same storage) that autograd sees as
    leaves, each with its ``.grad`` preset to its place in ``grads`` (the
    same layout), so a backward adds into ``grads`` in place.  Under
    ``"stack"`` one alias per layer (a list, which ``_index`` takes as the
    stacked leaf), so a layer's gradient lands in its slice as the
    backward reaches it (``jax.lax.scan``'s stacked cotangent), not in a
    leaf-sized buffer per layer."""
    def alias(p, g):
        a = p.detach().requires_grad_()
        a.grad = g
        return a

    def layers(p, g):
        return [alias(p_i, g_i) for p_i, g_i in zip(p.unbind(0), g.unbind(0))]

    def tree(p_tree, g_tree, fn):
        it = (fn(p, g) for p, g in _leaves(p_tree, g_tree))
        return _map(p_tree, lambda _: next(it))

    return {k: tree(params[k], grads[k], layers if k == "stack" else alias)
            for k in params}


def _stack(layers):
    """The inverse of ``_index``: per-layer trees -> one stacked tree."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in layers]) for k in first}
    if isinstance(first, tuple):
        return type(first)(*(_stack([t[j] for t in layers])
                             for j in range(len(first))))
    return torch.stack(layers)


def _mask_pad_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Vocab-padding mask: padded classes get -1e30 so sampling ignores
    them."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab
    return logits.masked_fill(pad, -1e30)


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x)
    else:
        logits = dense(params["head"], x)
    logits = _mask_pad_logits(logits, cfg)
    if cfg.logit_cap > 0:
        logits = cfg.logit_cap * torch.tanh(logits / cfg.logit_cap)
    return logits


def _embed_input(params: dict, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """(B, S, D) activations from {"tokens": (B, S) or (B,)} or
    {"embeds": (B, S, D) or (B, D)}."""
    dt = cfg.adtype
    if "embeds" in batch:
        x = batch["embeds"].to(dt)
        x = x[:, None] if x.dim() == 2 else x
    else:
        tok = batch["tokens"]
        x = embed(params["embed"], tok[:, None] if tok.dim() == 1 else tok,
                  dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return x


def forward(params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            use_chunked: Optional[bool] = None, mesh=None) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V).

    batch: {"tokens": (B, S)} or {"embeds": (B, S, D)}.  ``use_chunked``
    picks the attention layers' (and MLA's) chunked online softmax
    (default: where S passes ``q_chunk``).  ``mesh`` (a
    ``launch.mesh.Mesh``) reaches the attention layers, which with
    ``seq_shard_attn`` take the sequence-parallel route where JAX's would
    engage, and the MoE layers, expert-parallel over its "model" axis.
    """
    _require_ported(cfg)
    x = _embed_input(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    prefix, pat, n_blocks, rem = _layer_groups(cfg)
    for lp, k in zip(params.get("prefix", []), prefix):
        x = _apply_layer(lp, x, cfg, k, positions, use_chunked, mesh)

    def block(x, lp):
        for i, k in enumerate(pat):
            x = _apply_layer(lp[_block_key(i, k)], x, cfg, k, positions,
                             use_chunked, mesh)
        return x

    remat = cfg.remat and torch.is_grad_enabled()
    for n in range(n_blocks):
        lp = _index(params["stack"], n)
        x = (checkpoint(block, x, lp, use_reentrant=False) if remat
             else block(x, lp))
    for lp, k in zip(params.get("rem", []), rem):
        x = _apply_layer(lp, x, cfg, k, positions, use_chunked, mesh)
    return _logits(params, x, cfg)


# ---------------------------------------------------------------------------
# decode (single-token serve step)
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                 dtype: torch.dtype, device: torch.device):
    if kind == "S":
        return ssd_mod.init_ssd_state(batch, cfg.ssd_cfg(), dtype, device)
    if kind == "R":
        return rglru_mod.init_rglru_state(batch, cfg.rglru_cfg(), dtype,
                                          device)
    if cfg.use_mla:
        return mla_mod.init_mla_cache(batch, s_max, cfg.mla_cfg(), dtype,
                                      device)
    return attn_mod.init_kv_cache(batch, s_max, cfg.attn_cfg(_window(cfg)),
                                  dtype, device)


def init_decode_state(cfg: ModelConfig, batch: int, s_max: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> dict:
    """Per-layer state tree, stacked along the layer axis for the stack
    (the prefix and remainder lists): the SSM or RG-LRU state
    (constant-size), the KV cache of ``s_max`` positions (a ring of
    ``min(s_max, window)`` slots on the hybrid family's local attention)
    or MLA's latent cache of ``s_max`` positions.  ``device`` defaults to
    the card (``resolve_device``)."""
    _require_ported(cfg)
    device = resolve_device(device)
    prefix, pat, n_blocks, rem = _layer_groups(cfg)
    state: Dict[str, Any] = {}
    if prefix:
        state["prefix"] = [_layer_cache(cfg, k, batch, s_max, dtype, device)
                           for k in prefix]
    if n_blocks:
        block = {_block_key(i, k): _layer_cache(cfg, k, batch, s_max, dtype,
                                                device)
                 for i, k in enumerate(pat)}
        state["stack"] = _stack([block] * n_blocks)
    if rem:
        state["rem"] = [_layer_cache(cfg, k, batch, s_max, dtype, device)
                        for k in rem]
    return state


def _decode_layer(lp: dict, x: torch.Tensor, cache, cfg: ModelConfig,
                  kind: str):
    if kind == "S":
        y, nc = ssd_mod.ssd_decode_step(lp["ssd"], rmsnorm(lp["norm"], x),
                                        cache, cfg.ssd_cfg())
        return x + y, nc
    if kind == "R":
        y, nc = rglru_mod.rglru_decode_step(lp["rec"], rmsnorm(lp["norm"], x),
                                            cache, cfg.rglru_cfg())
        h = x + y
        return h + ffn(lp["ffn"], rmsnorm(lp["ln2"], h), cfg.act), nc
    h = rmsnorm(lp["ln1"], x)
    if cfg.use_mla:
        y, nc = mla_mod.mla_decode(lp["attn"], h, cache, cfg.mla_cfg(),
                                   absorb=cfg.mla_absorb)
    else:
        y, nc = attn_mod.decode_attention(lp["attn"], h, cache,
                                          cfg.attn_cfg(_window(cfg)))
    x = x + y
    return x + _channel_mix(lp, rmsnorm(lp["ln2"], x), cfg), nc


def _decode_unrolled(layers: list, kinds, caches: list, x: torch.Tensor,
                     cfg: ModelConfig):
    """Decode steps through a list of unrolled layers (the prefix or the
    remainder): (x, their new caches)."""
    new = []
    for lp, k, c in zip(layers, kinds, caches):
        x, nc = _decode_layer(lp, x, c, cfg, k)
        new.append(nc)
    return x, new


def decode_step(params: dict, state: dict, batch_t: Dict[str, torch.Tensor],
                cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One serve step: next-token logits (B, V) + the updated state."""
    _require_ported(cfg)
    x = _embed_input(params, batch_t, cfg)
    prefix, pat, n_blocks, rem = _layer_groups(cfg)
    new_state: Dict[str, Any] = {}
    if prefix:
        x, new_state["prefix"] = _decode_unrolled(
            params["prefix"], prefix, state["prefix"], x, cfg)
    if n_blocks:
        blocks = []
        for n in range(n_blocks):
            lp, cache = _index(params["stack"], n), _index(state["stack"], n)
            new_blk = {}
            for i, k in enumerate(pat):
                key = _block_key(i, k)
                x, new_blk[key] = _decode_layer(lp[key], x, cache[key], cfg,
                                                k)
            blocks.append(new_blk)
        new_state["stack"] = _stack(blocks)
    if rem:
        x, new_state["rem"] = _decode_unrolled(params["rem"], rem,
                                               state["rem"], x, cfg)
    return _logits(params, x, cfg)[:, 0], new_state
