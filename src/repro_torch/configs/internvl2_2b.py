"""internvl2-2b [vlm] — InternViT frontend (stubbed patch embeddings) +
InternLM2 LM backbone [arXiv:2404.16821; hf], as in
``repro/configs/internvl2_2b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92553, block_pattern=("attn",),
    mlp_type="swiglu", norm="rmsnorm", n_patches=256, tie_embeddings=True,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=512, n_patches=4)
