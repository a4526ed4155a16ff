"""gemma2-9b [dense] — local+global alternating attention, logit softcap,
sandwich norms [arXiv:2408.00118; hf], as in
``repro/configs/gemma2_9b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_ff=14336, vocab_size=256000, block_pattern=("local", "global"),
    window_size=4096, attn_softcap=50.0, final_softcap=30.0,
    sandwich_norm=True, scale_embed=True, mlp_type="swiglu", norm="rmsnorm",
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=512, window_size=8)
