"""llama4-scout-17b-a16e [moe] — 16 routed experts top-1 + shared expert,
early fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified], as in
``repro/configs/llama4_scout_17b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=8192, vocab_size=202048, block_pattern=("moe",),
    n_experts=16, top_k=1, shared_expert=True, mlp_type="swiglu",
    norm="rmsnorm", tie_embeddings=False,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=96, vocab_size=512, n_experts=4)
