"""qwen1.5-4b [hf:Qwen]: 40L d_model=2560 20H (kv=20) head_dim=128
d_ff=6912 vocab=151936 — QKV bias.

``CONFIG`` and ``SMOKE`` as ``repro.configs.qwen1p5_4b`` declares them."""

from ..models.model import ModelConfig
from .base import SKIP_LONG, ArchSpec, register

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab=151936, qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=64, qkv_bias=True, dtype="float32",
)

register(ArchSpec("qwen1.5-4b", CONFIG, SMOKE, skips=dict(SKIP_LONG)))
