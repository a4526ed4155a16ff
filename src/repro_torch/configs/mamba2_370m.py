"""mamba2-370m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified], as in ``repro/configs/mamba2_370m.py``.
n_heads/n_kv_heads are placeholders for the (unused) attention dims; the
SSD heads come from d_inner / ssm_head_dim."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab_size=50280, block_pattern=("mamba",),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    norm="rmsnorm", tie_embeddings=True,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         vocab_size=512, ssm_state=16, ssm_head_dim=16,
                         ssm_chunk=8)
