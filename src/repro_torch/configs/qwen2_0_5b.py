"""qwen2-0.5b [dense] — GQA kv=2, QKV bias [arXiv:2407.10671; hf], as in
``repro/configs/qwen2_0_5b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151936, block_pattern=("attn",), qkv_bias=True,
    mlp_type="swiglu", norm="rmsnorm", tie_embeddings=True,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
                         d_ff=112, vocab_size=512)
