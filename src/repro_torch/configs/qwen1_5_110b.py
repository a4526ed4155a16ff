"""qwen1.5-110b [dense] — GQA + QKV bias [hf:Qwen/Qwen1.5-0.5B; hf], as in
``repro/configs/qwen1_5_110b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab_size=152064, block_pattern=("attn",), qkv_bias=True,
    mlp_type="swiglu", norm="rmsnorm", tie_embeddings=False,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=8, n_kv_heads=1,
                         d_ff=192, vocab_size=512)
