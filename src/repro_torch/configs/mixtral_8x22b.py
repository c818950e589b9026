"""mixtral-8x22b [arXiv:2401.04088; hf] — 8-expert top-2 MoE + SWA.

Sliding-window attention (4096) => sub-quadratic => runs long_500k with a
rolling window cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    mlp="swiglu", n_experts=8, experts_per_token=2,
    sliding_window=4096, rope_theta=1e6, sub_quadratic=True,
    source="arXiv:2401.04088; hf",
)
