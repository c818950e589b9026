"""Model/config dataclasses shared by every architecture."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    mlp: str = "swiglu"              # swiglu | relu2 | gelu
    norm: str = "rmsnorm"
    rope: bool = True
    rope_theta: float = 1e4
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)
    qkv_bias: bool = False
    sliding_window: int | None = None
    # MoE
    n_experts: int = 0
    experts_per_token: int = 2
    moe_d_ff: int | None = None
    moe_dense_residual: bool = False
    # SSM
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0              # hybrid: shared attn every k layers
    # enc-dec (audio)
    encoder_layers: int = 0
    encoder_frames: int = 1500
    frontend: str | None = None      # 'audio' | 'vision' (stub)
    # training
    optimizer: str = "adamw"         # adamw | adafactor
    #: gradient-accumulation dtype; bf16 halves accumulator memory for
    #: the biggest models (arctic: fp32 accumulators alone are 7.3 GiB
    #: per device at 256 chips)
    grad_accum_dtype: str = "float32"
    remat: bool = True
    # metadata
    source: str = ""
    sub_quadratic: bool = False      # can run long_500k

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

    def encoder_cfg(self) -> "ModelConfig":
        """Whisper encoder layers: non-causal dense blocks, no rope."""
        return dataclasses.replace(
            self, family="dense", rope=False, n_experts=0,
            n_kv_heads=self.n_heads)

    def reduced(self) -> "ModelConfig":
        """Smoke-test configuration of the same family: small widths,
        few layers/experts, tiny vocab — same code paths."""
        return dataclasses.replace(
            self,
            n_layers=max(2, self.attn_every or 2),
            d_model=64,
            n_heads=4, n_kv_heads=2 if self.n_kv_heads < self.n_heads
            else 4,
            head_dim=16,
            d_ff=128, vocab_size=512,
            moe_d_ff=64 if self.n_experts else None,
            n_experts=min(self.n_experts, 4),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            attn_every=2 if self.attn_every else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_frames=32 if self.encoder_layers else 1500,
            sliding_window=64 if self.sliding_window else None,
            mrope_sections=(4, 2, 2) if self.mrope else (16, 24, 24),
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        hd = self.head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.mlp == "swiglu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.family == "ssm":
            d_inner = self.ssm_expand * d
            nheads = d_inner // self.ssm_head_dim
            block = d * (2 * d_inner + 2 * self.ssm_state + nheads) \
                + d_inner * d
        elif self.n_experts > 0:
            eff = self.moe_d_ff or self.d_ff
            block = attn + self.n_experts * 3 * d * eff + d * \
                self.n_experts
            if self.moe_dense_residual:
                block += 3 * d * self.d_ff
        elif self.family == "hybrid":
            d_inner = self.ssm_expand * d
            nheads = d_inner // self.ssm_head_dim
            block = d * (2 * d_inner + 2 * self.ssm_state + nheads) \
                + d_inner * d
        else:
            block = attn + mlp
        total = 2 * v * d + self.n_layers * block
        if self.family == "hybrid":
            total += attn          # one shared attention block
        if self.family == "audio":
            total += self.encoder_layers * (attn + mlp) \
                + self.n_layers * attn          # cross-attention
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        eff = self.moe_d_ff or self.d_ff
        hd = self.head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        block = attn + self.experts_per_token * 3 * d * eff
        if self.moe_dense_residual:
            block += 3 * d * self.d_ff
        return int(2 * self.vocab_size * d + self.n_layers * block)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
