"""qwen2.5-14b [dense] — GQA + QKV bias [hf:Qwen/Qwen2.5-0.5B; hf], as in
``repro/configs/qwen2_5_14b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab_size=152064, block_pattern=("attn",), qkv_bias=True,
    mlp_type="swiglu", norm="rmsnorm", tie_embeddings=False,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=80, n_heads=5, n_kv_heads=1,
                         d_ff=160, vocab_size=512)
