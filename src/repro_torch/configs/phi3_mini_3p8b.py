"""phi3-mini-3.8b [arXiv:2404.14219]: 32L d_model=3072 32H (kv=32)
head_dim=96 d_ff=8192 vocab=32064 — RoPE + SwiGLU.

``CONFIG`` and ``SMOKE`` as ``repro.configs.phi3_mini_3p8b`` declares them."""

from ..models.model import ModelConfig
from .base import SKIP_LONG, ArchSpec, register

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064,
)

SMOKE = ModelConfig(
    name="phi3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=64, dtype="float32",
)

register(ArchSpec("phi3-mini-3.8b", CONFIG, SMOKE, skips=dict(SKIP_LONG)))
