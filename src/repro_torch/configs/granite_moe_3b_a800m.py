"""granite-moe-3b-a800m [hf:ibm-granite]: 32L d_model=1536 24H (kv=8)
d_ff=512 (per-expert) vocab=49155, MoE 40 experts top-8 (assignment header;
the hf 1b-a400m card lists 32 — we follow the assigned 40).  Experts are
padded 40 -> 48 for the 16-way model axis (router masks the 8 pads).
Embeddings tied (granite style).

``CONFIG`` and ``SMOKE`` as ``repro.configs.granite_moe_3b_a800m`` declares
them."""

from ..models.model import ModelConfig
from .base import SKIP_LONG, ArchSpec, register

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    n_experts=40, n_experts_pad=48, top_k=8, d_ff_expert=512,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab=64, n_experts=5, n_experts_pad=8, top_k=2,
    d_ff_expert=32, tie_embeddings=True, dtype="float32",
)

register(ArchSpec("granite-moe-3b-a800m", CONFIG, SMOKE,
                  skips=dict(SKIP_LONG)))
