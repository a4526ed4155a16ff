"""dbrx-132b [moe] — 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified], as in
``repro/configs/dbrx_132b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352, block_pattern=("moe",),
    n_experts=16, top_k=4, mlp_type="swiglu", norm="rmsnorm",
    tie_embeddings=False,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=96, vocab_size=512, n_experts=4, top_k=2)
