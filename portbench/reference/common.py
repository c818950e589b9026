"""Plain float32 building blocks of the reference models: linear maps,
RMSNorm, half-split rotary embeddings, causal (and windowed) attention
computed a block of query rows at a time, and the SwiGLU expert.

The reference is written from the models' published description and
imports nothing of the program. It takes the benchmark's bf16 weights
and computes in float32 with TF32 off. With `control=True` every
linear map instead takes its weights rounded to fp8 (e4m3, a scale per
output column) and its inputs rounded to fp8 (a scale per row): the
W8A8 step down from the served bf16 that the comparison has to catch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
#: Query rows a block of the reference's attention.
ATTN_BLOCK = 512


def full_precision() -> None:
    """float32 matrix products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` rounded to e4m3 with one scale per slice reduced over `dim`
    (its largest magnitude maps to e4m3's largest), back in float32."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (t / s).to(FP8).float() * s


def weight(w: torch.Tensor, control: bool) -> torch.Tensor:
    """A (..., d_in, d_out) weight in float32, or rounded to fp8 a
    column at a time for the control."""
    w = w.float()
    return fp8_round(w, -2) if control else w


def linear(x: torch.Tensor, w: torch.Tensor, control: bool) -> torch.Tensor:
    """x @ w, with x rounded to fp8 a row at a time for the control (w
    from `weight`)."""
    return (fp8_round(x, -1) if control else x) @ w


def rmsnorm(x, scale, eps: float = 1e-5):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def silu(x):
    return x * torch.sigmoid(x)


def rope(x, theta: float):
    """Rotary embedding of x (B, H, L, D) at positions 0..L-1, the first
    and second halves of D being the two coordinates of each pair."""
    d, l = x.shape[-1], x.shape[-2]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(l, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, window: int | None):
    """Causal softmax attention, float32: q (B, Hq, L, D), k and v
    (B, Hkv, L, D); a key is seen when it is not after the query and,
    with a window, less than `window` positions behind it."""
    b, hq, l, d = q.shape
    rep = hq // k.shape[1]
    out = torch.empty_like(q)
    kpos = torch.arange(l, device=q.device)
    for i in range(b):
        ki = k[i].repeat_interleave(rep, 0)
        vi = v[i].repeat_interleave(rep, 0)
        for q0 in range(0, l, ATTN_BLOCK):
            qpos = torch.arange(q0, min(q0 + ATTN_BLOCK, l),
                                device=q.device)[:, None]
            seen = kpos[None] <= qpos
            if window is not None:
                seen &= qpos - kpos[None] < window
            s = (q[i, :, q0:q0 + ATTN_BLOCK] @ ki.mT) * d ** -0.5
            s = s.masked_fill(~seen, float("-inf"))
            out[i, :, q0:q0 + ATTN_BLOCK] = torch.softmax(s, -1) @ vi
    return out


def attention_block(w: dict, x, cfg, control: bool):
    """The attention sublayer on normed x (B, L, d): projections, rotary,
    causal attention, output projection. `w` holds float32 weights."""
    b, l, _ = x.shape
    hd = cfg.head_dim

    def heads(t, n):
        return t.reshape(b, l, n, hd).transpose(1, 2)

    q = heads(linear(x, w["wq"], control), cfg.n_heads)
    k = heads(linear(x, w["wk"], control), cfg.n_kv_heads)
    v = heads(linear(x, w["wv"], control), cfg.n_kv_heads)
    if cfg.rope:
        q, k = rope(q, cfg.rope_theta), rope(k, cfg.rope_theta)
    o = attention(q, k, v, cfg.sliding_window)
    o = o.transpose(1, 2).reshape(b, l, cfg.n_heads * hd)
    return linear(o, w["wo"], control)


def attention_weights(p: dict, control: bool) -> dict:
    return {n: weight(p[n]["w"], control) for n in ("wq", "wk", "wv", "wo")}


def take(tree, i: int):
    """Layer i of a tree of stacked tensors."""
    if isinstance(tree, dict):
        return {k: take(v, i) for k, v in tree.items()}
    return tree[i]


def embed(params, tokens):
    return F.embedding(tokens, params["embed"]["w"]).float()


def head(cfg, params, x, control: bool):
    """Final norm and LM head: float32 logits."""
    h = rmsnorm(x, params["final_norm"]["scale"])
    return linear(h, weight(params["lm_head"]["w"], control), control)
