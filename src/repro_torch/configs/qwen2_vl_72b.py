"""qwen2-vl-72b [arXiv:2409.12191; hf] — VLM backbone with M-RoPE.

Backbone only: the vision frontend is a STUB — input_specs() provides
precomputed patch embeddings that replace the first positions of the
sequence (dynamic resolution handling is out of scope per assignment).
Full attention => skips long_500k. Adafactor (72B).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    mlp="swiglu", qkv_bias=True, mrope=True,
    mrope_sections=(16, 24, 24), rope_theta=1e6,
    frontend="vision", optimizer="adafactor",
    source="arXiv:2409.12191; hf",
)
