"""Shared neural building blocks: norms, RoPE / M-RoPE, MLP variants,
embeddings, the sinusoidal position table, as `repro.models.layers` has
them. Parameters are plain
dicts of tensors; math that needs range (normalization statistics,
rotary) runs in float32, and results come back in the input's dtype.

Initializers draw from an explicit `torch.Generator` on the parameters'
device (on `meta` they allocate and draw nothing). They give other
numbers than `jax.random` from the same seed: tests carry the
reference's weights across with `repro_torch.convert.lm_params_from_numpy`
instead.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.launch import sharding as shd


def normal(gen: torch.Generator, shape, std: float, dtype,
           device) -> torch.Tensor:
    """Normal(0, std) draws in float32, cast to `dtype`. On the `meta`
    device (shapes only, for the dry-run) nothing is drawn and `gen` may
    be None."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * std).to(dtype)


def rmsnorm_init(d: int, dtype=torch.bfloat16, device=None, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype=torch.bfloat16, device=None, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return rmsnorm_init, rmsnorm
    return layernorm_init, layernorm


def dense_init(gen, d_in: int, d_out: int, bias: bool = False,
               dtype=torch.bfloat16, scale: float | None = None,
               device=None, lead=()):
    """`lead` prepends stacked dimensions (one weight per layer)."""
    if scale is None:
        scale = d_in ** -0.5
    p = {"w": normal(gen, (*lead, d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def dense(params, x):
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


# --- rotary embeddings -----------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate_half(x, cos, sin):
    """The half-split layout: the first and second halves of the head
    dim are the two coordinates of each rotated pair."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x, positions, theta: float = 1e4):
    """x: (B, H, L, D); positions: (B, L) integer."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[:, None, :, None].float() * freqs
    return _rotate_half(x, torch.cos(angles), torch.sin(angles))


def apply_mrope(x, positions, sections=(16, 24, 24), theta: float = 1e4):
    """Qwen2-VL multimodal RoPE: the head_dim/2 frequency slots are split
    into (temporal, height, width) sections, each rotated by its own
    position stream. x: (B, H, L, D); positions: (B, 3, L)."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    sec_id = torch.as_tensor(np.concatenate(
        [np.full(s, i) for i, s in enumerate(sections)]), device=x.device)
    pos = positions.float()[:, sec_id, :]                   # (B, half, L)
    angles = (pos * freqs[None, :, None]).movedim(1, -1)[:, None]
    return _rotate_half(x, torch.cos(angles), torch.sin(angles))


# --- MLP variants ----------------------------------------------------------

def mlp_init(gen, d: int, d_ff: int, kind: str, dtype=torch.bfloat16,
             device=None, lead=()):
    kw = dict(dtype=dtype, device=device, lead=lead)
    if kind == "swiglu":
        return {"gate": dense_init(gen, d, d_ff, **kw),
                "up": dense_init(gen, d, d_ff, **kw),
                "down": dense_init(gen, d_ff, d, **kw)}
    return {"up": dense_init(gen, d, d_ff, **kw),
            "down": dense_init(gen, d_ff, d, **kw)}


def mlp_apply(params, x, kind: str):
    if kind == "swiglu":
        h = F.silu(dense(params["gate"], x)) * dense(params["up"], x)
    elif kind == "relu2":          # nemotron squared-ReLU
        h = torch.square(F.relu(dense(params["up"], x)))
    else:                          # gelu (whisper): jax.nn.gelu's tanh form
        h = F.gelu(dense(params["up"], x), approximate="tanh")
    h = shd.constrain(h, "ffn_hidden")
    return dense(params["down"], h)


def embedding_init(gen, vocab: int, d: int, dtype=torch.bfloat16,
                   device=None):
    return {"w": normal(gen, (vocab, d), 0.02, dtype, device)}


def embed(params, tokens):
    """Rows of the table: `F.embedding`, whose backward on the card sums
    a repeated token's rows over sorted indices in a fixed order (an
    indexing gather's would add them with `index_put_` atomics). On a
    vocab-sharded table (a DTensor) the width is gathered first, each
    rank looks up its own rows, and the masked partial rows are summed at
    once: DTensor's masked lookup holds only for a table split by rows,
    and cannot be reduced into another layout later. The gradient coming
    back is settled into the output's layout first, for the same reason
    (a partial sum cannot become the masked one)."""
    w = shd.replicate(params["w"], dims=(1,))
    return shd.grad_like(shd.replicate(F.embedding(tokens, w), dims=()))


def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    """Whisper's fixed (length, d) float32 position table: sin on the even
    columns, cos on the odd ones."""
    pos = np.arange(length)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    angle = pos / np.power(10000.0, dim / d)
    out = np.zeros((length, d), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return torch.from_numpy(out).to(device)


def softplus(x):
    """`jax.nn.softplus`: log1p(exp(-|x|)) + max(x, 0) everywhere.
    (`F.softplus` returns x itself above its threshold of 20; the two
    differ there by under 1e-8 relative, but this one is the
    reference's function.)"""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp(min=0)
