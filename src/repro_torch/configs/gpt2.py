"""GPT-2 small/medium/large (the paper's model family), as in
``repro/configs/gpt2.py``: LayerNorm + GELU + QKV bias, RoPE in place of
learned positions."""
from repro_torch.models.common import ModelConfig

GPT2_SMALL = ModelConfig(
    name="gpt2-small", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=50257, block_pattern=("attn",), qkv_bias=True,
    mlp_type="gelu", norm="layernorm", tie_embeddings=True,
)
GPT2_MEDIUM = GPT2_SMALL.replace(name="gpt2-medium", n_layers=24,
                                 d_model=1024, n_heads=16, n_kv_heads=16,
                                 d_ff=4096)
GPT2_LARGE = GPT2_SMALL.replace(name="gpt2-large", n_layers=36,
                                d_model=1280, n_heads=20, n_kv_heads=20,
                                d_ff=5120)
CONFIG = GPT2_SMALL
REDUCED = GPT2_SMALL.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                             d_ff=256, vocab_size=512)
