"""mamba2-2.7b [arXiv:2405.21060; unverified] — SSD, attention-free.

Attention-free => sub-quadratic => runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=50280, head_dim=64,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    rope=False, sub_quadratic=True,
    source="arXiv:2405.21060; unverified",
)
