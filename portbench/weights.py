"""Seeded random weights, made on the device in the layout
`repro_torch.models.transformer.init_params` returns, so that the same
tensors go to the program and to the plain reference.

A family's file, `portbench/params/<family>.py`, draws its weights from
the `Maker` here. Each stacked tensor is drawn in one call, in the type
it is served in (bf16; the MoE router in float32), from one
`torch.Generator` on the device. The distributions are those of a
freshly initialised model, with norm scales drawn about their initial
value, so that every parameter the program reads changes the result.
"""
from __future__ import annotations

import torch

from portbench.harness import load

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


def permute_(t, perm, dim: int) -> None:
    """Puts what index `perm[i]` of `t` held along `dim` at index i, in
    place, through one slice's copy: a stacked weight is reordered with
    no second copy of it."""
    done = [False] * len(perm)
    for i in range(len(perm)):
        if done[i] or int(perm[i]) == i:
            continue
        held, j = t.select(dim, i).clone(), i
        while not done[j]:
            done[j], src = True, int(perm[j])
            t.select(dim, j).copy_(held if src == i else t.select(dim, src))
            j = src


def make_params(cfg, seed: int, device, find=None, order=None) -> dict:
    """The model's weights for `seed` on `device`, drawn by its family's
    file, `portbench/params/<family>.py` (`make(m, cfg)`), which `find`
    loads (a `Bench`'s `module`, which looks under its root first; by
    default the file beside the harness). With `order`, a numpy
    generator, the family's `order(params, cfg, rng)`, where its file has
    one, then reorders them in place without changing what they compute
    (the MoE family's experts)."""
    try:
        family = (find or load)("params", cfg.family)
    except FileNotFoundError:
        raise ValueError(f"{cfg.name}: no weights for family "
                         f"{cfg.family!r} (portbench/params/"
                         f"{cfg.family}.py)") from None
    params = family.make(Maker(seed, device), cfg)
    if order is not None and hasattr(family, "order"):
        family.order(params, cfg, order)
    return params
