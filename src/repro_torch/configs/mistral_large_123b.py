"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407]: 88L
d_model=12288 96H (kv=8) head_dim=128 d_ff=28672 vocab=32768.

``CONFIG`` and ``SMOKE`` as ``repro.configs.mistral_large_123b`` declares them."""

from ..models.model import ModelConfig
from .base import SKIP_LONG, ArchSpec, register

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=32768,
)

SMOKE = ModelConfig(
    name="mistral-large-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab=64, dtype="float32",
)

register(ArchSpec("mistral-large-123b", CONFIG, SMOKE,
                  skips=dict(SKIP_LONG)))
