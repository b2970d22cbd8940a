"""recurrentgemma-9b [arXiv:2402.19427]: 38L d_model=4096 16H MQA(kv=1)
head_dim=256 d_ff=12288 vocab=256000 — Griffin: RG-LRU + 2048-window local
attention, pattern (R, R, A); lru width 4096.  38 = 12 x (R,R,A) + (R,R)
remainder (12 stacked pattern blocks + 2 unrolled layers).

``CONFIG`` and ``SMOKE`` as ``repro.configs.recurrentgemma_9b`` declares
them.  All four shape cells apply: the decode state is O(1) per recurrent
layer and the window cache a 2048-slot ring."""

from ..models.model import ModelConfig
from .base import ArchSpec, register

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    window=2048, pattern=("R", "R", "A"), lru_width=4096,
    act="gelu", glu=True, tie_embeddings=True, embed_scale=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=64, window=8, pattern=("R", "R", "A"), lru_width=64,
    act="gelu", glu=True, tie_embeddings=True, embed_scale=True,
    dtype="float32",
)

register(ArchSpec("recurrentgemma-9b", CONFIG, SMOKE, skips={}))
