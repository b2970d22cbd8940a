"""mamba2-2.7b [arXiv:2405.21060]: 64L d_model=2560 attn-free, vocab=50280,
ssm_state=128 — SSD (state-space duality), d_inner = 2*d = 5120, 80 heads of
dim 64, d_conv 4.  The causal depthwise conv stem is the ConvDK hot-spot.

``CONFIG`` and ``SMOKE`` as ``repro.configs.mamba2_2p7b`` declares them; the
kernel path is ``dataclasses.replace(CONFIG, use_convdk_kernel=True)``."""

from ..models.model import ModelConfig
from .base import ArchSpec, register

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, vocab=50280,
    d_state=128, d_conv=4, expand=2, ssd_chunk=256,
    n_heads=80, n_kv_heads=80, head_dim=64,  # SSD heads (d_inner/64)
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, vocab=64, d_state=16, d_conv=4, expand=2,
    ssd_chunk=16, n_heads=2, n_kv_heads=2, head_dim=64, dtype="float32",
)

register(ArchSpec("mamba2-2.7b", CONFIG, SMOKE, skips={}))
