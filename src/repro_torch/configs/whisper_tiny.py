"""whisper-tiny [audio] — encoder-decoder; the conv frontend is a stub:
callers pass precomputed frame embeddings [arXiv:2212.04356; unverified],
as in ``repro/configs/whisper_tiny.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", n_layers=4, n_enc_layers=4, d_model=384, n_heads=6,
    n_kv_heads=6, d_ff=1536, vocab_size=51865, block_pattern=("attn",),
    mlp_type="gelu", norm="layernorm", n_audio_frames=1500, tie_embeddings=True,
)

REDUCED = CONFIG.replace(n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
                         n_kv_heads=4, d_ff=128, vocab_size=512,
                         n_audio_frames=16)
