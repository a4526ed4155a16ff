"""zamba2-1.2b [hybrid] — Mamba2 backbone + ONE shared attention+MLP block
applied every 6 layers [arXiv:2411.15242; hf], as in
``repro/configs/zamba2_1_2b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000, block_pattern=("mamba",),
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    shared_attn_every=6, mlp_type="swiglu", norm="rmsnorm", tie_embeddings=True,
)

REDUCED = CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab_size=512, ssm_state=16,
                         ssm_head_dim=16, ssm_chunk=8, shared_attn_every=2)
