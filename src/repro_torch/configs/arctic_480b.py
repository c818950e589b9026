"""arctic-480b [hf:Snowflake/snowflake-arctic-base; hf] — 128-expert
top-2 MoE with a dense SwiGLU residual branch.

468B total parameters: Adafactor optimizer (fp32 Adam moments would not
fit the single-pod mesh; see DESIGN.md §5/§6 and EXPERIMENTS.md §Dry-run).
Full attention => skips long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000, head_dim=128,
    mlp="swiglu", n_experts=128, experts_per_token=2,
    moe_d_ff=4864, moe_dense_residual=True,
    optimizer="adafactor", grad_accum_dtype="bfloat16",
    rope_theta=1e4,
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
