"""whisper-tiny [arXiv:2212.04356; unverified] — enc-dec with a stubbed
conv frontend: input_specs() provides precomputed 1500-frame embeddings
(post-conv mel features). kv=6 == heads (MHA). Full attention => skips
long_500k; enc-dec (not encoder-only) => decode shapes run."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
    mlp="gelu", norm="layernorm", rope=False,
    encoder_layers=4, encoder_frames=1500, frontend="audio",
    source="arXiv:2212.04356; unverified",
)
