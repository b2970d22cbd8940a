"""Model assembly of the language-model families: the config, the parameter
tree, the full-sequence forward and the single-token decode step.

Counterpart of ``repro.models.model``.  ``ModelConfig`` carries every field
of the JAX package's, so its configs copy over unchanged.  The ported
family is ``"ssm"`` (Mamba-2: a stack of SSD layers, ``models.ssd``); any
other family raises ``NotImplementedError`` (ROADMAP A item 12 lists them
in port order).

Per-layer parameters are stacked on a leading layer axis (the key
``"stack"``, the block's layer ``"0_S"``), the JAX package's
scan-over-layers layout, so its param trees carry over key for key.  The
JAX ``lax.scan`` over the stack becomes a Python loop that indexes the
stacked tensors layer by layer (views, no copies); ``remat`` and
``scan_layers`` are kept as fields with no effect until training is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..kernels.common import resolve_device
from . import ssd as ssd_mod
from .common import (
    dense, embed, embed_def, head_def, rmsnorm, rmsnorm_def, unembed,
)
from .param import stack_defs

NOT_PORTED = "not ported yet (ROADMAP A item 12)"


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

    def ssd_cfg(self) -> ssd_mod.SSDConfig:
        return ssd_mod.SSDConfig(
            d_model=self.d_model, d_inner=self.d_inner,
            n_heads=self.d_inner // 64, head_dim=64, d_state=self.d_state,
            n_groups=1, d_conv=self.d_conv, chunk=self.ssd_chunk,
            use_kernel=self.use_convdk_kernel,
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


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is {NOT_PORTED}; the port "
            f"runs family 'ssm'")


# ---------------------------------------------------------------------------
# per-layer definitions (every layer of the "ssm" family is an SSD layer)
# ---------------------------------------------------------------------------

BLOCK = "0_S"   # the stacked block's one layer (the JAX key f"{i}_{kind}")


def _layer_def(cfg: ModelConfig) -> dict:
    return {"norm": rmsnorm_def(cfg.d_model),
            "ssd": ssd_mod.ssd_def(cfg.ssd_cfg())}


def _apply_layer(lp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x + ssd_mod.ssd_block(lp["ssd"], rmsnorm(lp["norm"], x),
                                 cfg.ssd_cfg())


def _layer_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(unrolled prefix layers, stacked layers): the JAX package's split
    without the hybrid family's pattern blocks and remainder."""
    n_prefix = min(cfg.n_dense_prefix, cfg.n_layers)
    return n_prefix, cfg.n_layers - n_prefix


def model_def(cfg: ModelConfig) -> dict:
    _require_ported(cfg)
    p: Dict[str, Any] = {"embed": embed_def(cfg.padded_vocab, cfg.d_model)}
    n_prefix, n_stack = _layer_groups(cfg)
    if n_prefix:
        p["prefix"] = [_layer_def(cfg) for _ in range(n_prefix)]
    if n_stack:
        p["stack"] = stack_defs({BLOCK: _layer_def(cfg)}, n_stack)
    p["final_norm"] = rmsnorm_def(cfg.d_model)
    if not cfg.tie_embeddings:
        p["head"] = head_def(cfg.d_model, cfg.padded_vocab)
    return p


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree: views of every leaf."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):          # a NamedTuple of state tensors
        return type(tree)(*(_index(v, i) for v in tree))
    return tree[i]


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


def forward(params: dict, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V).

    batch: {"tokens": (B, S)} or {"embeds": (B, S, D)}.
    """
    _require_ported(cfg)
    x = _embed_input(params, batch, cfg)
    for lp in params.get("prefix", []):
        x = _apply_layer(lp, x, cfg)
    for n in range(_layer_groups(cfg)[1]):
        x = _apply_layer(_index(params["stack"], n)[BLOCK], x, cfg)
    return _logits(params, x, cfg)


# ---------------------------------------------------------------------------
# decode (single-token serve step)
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, s_max: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> dict:
    """Per-layer state tree, stacked along the layer axis for the stack.
    ``s_max`` sizes attention caches; the SSM state is constant-size.
    ``device`` defaults to the card (``resolve_device``)."""
    _require_ported(cfg)
    device = resolve_device(device)
    n_prefix, n_stack = _layer_groups(cfg)

    def layer():
        return ssd_mod.init_ssd_state(batch, cfg.ssd_cfg(), dtype, device)

    state: Dict[str, Any] = {}
    if n_prefix:
        state["prefix"] = [layer() for _ in range(n_prefix)]
    if n_stack:
        state["stack"] = _stack([{BLOCK: layer()}] * n_stack)
    return state


def _decode_layer(lp: dict, x: torch.Tensor, cache, cfg: ModelConfig):
    y, nc = ssd_mod.ssd_decode_step(lp["ssd"], rmsnorm(lp["norm"], x),
                                    cache, cfg.ssd_cfg())
    return x + y, nc


def decode_step(params: dict, state: dict, batch_t: Dict[str, torch.Tensor],
                cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One serve step: next-token logits (B, V) + the updated state."""
    _require_ported(cfg)
    x = _embed_input(params, batch_t, cfg)
    new_state: Dict[str, Any] = {}
    if "prefix" in params:
        caches = []
        for lp, c in zip(params["prefix"], state["prefix"]):
            x, nc = _decode_layer(lp, x, c, cfg)
            caches.append(nc)
        new_state["prefix"] = caches
    if "stack" in params:
        layers = []
        for n in range(_layer_groups(cfg)[1]):
            x, nc = _decode_layer(_index(params["stack"], n)[BLOCK], x,
                                  _index(state["stack"], n)[BLOCK], cfg)
            layers.append({BLOCK: nc})
        new_state["stack"] = _stack(layers)
    return _logits(params, x, cfg)[:, 0], new_state
