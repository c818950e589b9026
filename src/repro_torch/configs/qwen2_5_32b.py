"""qwen2.5-32b [hf:Qwen/Qwen2.5-0.5B; hf] — dense GQA, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152064, head_dim=128,
    mlp="swiglu", qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
