"""zamba2-2.7b [arXiv:2411.15242; hf] — Mamba2 backbone with a weight-
shared attention block applied every 6 layers (GQA kv=32 => MHA).

SSM backbone => sub-quadratic => runs long_500k (shared-attention KV
grows, but only for n_layers/6 = 9 shared applications).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    attn_every=6, rope_theta=1e4, sub_quadratic=True,
    source="arXiv:2411.15242; hf",
)
