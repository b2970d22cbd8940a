"""deepseek-v2-236b [arXiv:2405.04434; hf]: 60L d_model=5120 128H d_ff=1536
(per-expert) vocab=102400, MoE 160 routed top-6 + 2 shared, MLA kv_lora=512.

MLA dims per the paper: q_lora 1536, kv_lora 512, d_nope 128, d_rope 64,
v head dim 128.  Layer 0 uses a dense FFN (d_ff 12288); experts are 160
(divisible by the 16-way model axis, no padding).  The 60 layers hold
about 236 B parameters, each MoE layer about 3.97 B: the whole model does
not fit one 80 GB card, which runs it at reduced depth.

``CONFIG`` and ``SMOKE`` as ``repro.configs.deepseek_v2_236b`` declares
them."""

from ..models.model import ModelConfig
from .base import SKIP_LONG, ArchSpec, register

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=12288, vocab=102400,
    n_experts=160, n_experts_pad=160, top_k=6, d_ff_expert=1536,
    n_shared_experts=2, n_dense_prefix=1,
    use_mla=True, q_lora=1536, kv_lora=512, d_nope=128, d_rope=64,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=8, head_dim=16,
    d_ff=128, vocab=64, n_experts=8, n_experts_pad=8, top_k=2,
    d_ff_expert=32, n_shared_experts=1, n_dense_prefix=1,
    use_mla=True, q_lora=32, kv_lora=16, d_nope=16, d_rope=8,
    dtype="float32",
)

register(ArchSpec("deepseek-v2-236b", CONFIG, SMOKE, skips=dict(SKIP_LONG)))
