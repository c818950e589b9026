"""Seeded random weights, made on the device in the layout
`repro_torch.models.transformer.init_params` returns, so that the same
tensors go to the program and to the plain reference.

Each stacked tensor is drawn in one call, in the type it is served in
(bf16; the MoE router in float32), from one `torch.Generator` on the
device. The distributions are those of a freshly initialised model,
with norm scales drawn about their initial value, so that every
parameter the program reads changes the result.
"""
from __future__ import annotations

import torch

NORM_SCALE_STD = 0.1
EMBED_STD = 0.02


class Maker:
    """Draws tensors from one generator on `device`."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, shape, std, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=self.gen, dtype=dtype,
                        device=self.device)
        return t.mul_(std)

    def norm(self, *shape):
        return {"scale": self.normal(shape, NORM_SCALE_STD).add_(1.0)}

    def dense(self, lead, d_in, d_out):
        return {"w": self.normal((*lead, d_in, d_out), d_in ** -0.5)}

    def attention(self, cfg, lead=()):
        d, hd = cfg.d_model, cfg.head_dim
        if cfg.qkv_bias:
            raise ValueError(f"{cfg.name}: QKV biases are not made here")
        return {"wq": self.dense(lead, d, cfg.n_heads * hd),
                "wk": self.dense(lead, d, cfg.n_kv_heads * hd),
                "wv": self.dense(lead, d, cfg.n_kv_heads * hd),
                "wo": self.dense(lead, cfg.n_heads * hd, d)}


def _moe(m: Maker, cfg, lead):
    d, e = cfg.d_model, cfg.n_experts
    dff = cfg.moe_d_ff or cfg.d_ff
    if cfg.moe_dense_residual:
        raise ValueError(f"{cfg.name}: a dense residual is not made here")
    return {"router": {"w": m.normal((*lead, d, e), d ** -0.5,
                                     torch.float32)},
            "gate": m.normal((*lead, e, d, dff), d ** -0.5),
            "up": m.normal((*lead, e, d, dff), d ** -0.5),
            "down": m.normal((*lead, e, dff, d), dff ** -0.5)}


def make_params(cfg, seed: int, device) -> dict:
    """The model's weights for `seed` on `device`: the MoE family."""
    if cfg.family != "moe":
        raise ValueError(f"{cfg.name}: no weights for family {cfg.family!r}")
    m = Maker(seed, device)
    lead = (cfg.n_layers,)
    layers = {"norm1": m.norm(*lead, cfg.d_model),
              "attn": m.attention(cfg, lead),
              "norm2": m.norm(*lead, cfg.d_model),
              "moe": _moe(m, cfg, lead)}
    params = {"embed": {"w": m.normal((cfg.vocab_size, cfg.d_model),
                                      EMBED_STD)},
              "layers": layers,
              "final_norm": m.norm(cfg.d_model),
              "lm_head": m.dense((), cfg.d_model, cfg.vocab_size)}
    return params
