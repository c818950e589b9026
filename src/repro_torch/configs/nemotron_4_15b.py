"""nemotron-4-15b [arXiv:2402.16819; unverified] — GQA, squared-ReLU."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab_size=256000, head_dim=128,
    mlp="relu2", norm="layernorm", rope_theta=1e4,
    source="arXiv:2402.16819; unverified",
)
