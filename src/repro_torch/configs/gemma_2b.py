"""gemma-2b [arXiv:2403.08295; hf]: 18L d_model=2048 8H MQA(kv=1)
head_dim=256 d_ff=16384 vocab=256000 — GeGLU, tied embeddings, sqrt(d)
embedding scale.

``CONFIG`` and ``SMOKE`` as ``repro.configs.gemma_2b`` declares them."""

from ..models.model import ModelConfig
from .base import SKIP_LONG, ArchSpec, register

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000,
    act="gelu", glu=True, tie_embeddings=True, embed_scale=True,
)

SMOKE = ModelConfig(
    name="gemma-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=64, act="gelu", glu=True, tie_embeddings=True,
    embed_scale=True, dtype="float32",
)

register(ArchSpec("gemma-2b", CONFIG, SMOKE, skips=dict(SKIP_LONG)))
