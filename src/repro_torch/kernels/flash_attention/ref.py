"""Plain torch version of the flash-attention kernel: the naive-softmax
oracle of `repro.kernels.flash_attention.ref`, float32 throughout, with
the kernel's end alignment (queries sit at the last Lq positions of the
keys) and the finite masking value NEG."""
from __future__ import annotations

import torch

NEG = -1e30


def _masked_scores(q, k, causal, window):
    """Float32 scores q k^T D^-1/2, masked to NEG (queries end-aligned)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    lq, lk = q.shape[2], k.shape[2]
    qi = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    kj = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= (qi - kj) < window
    return torch.where(mask, s, torch.full((), NEG, device=q.device))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  window: int | None = None) -> torch.Tensor:
    """q: (B, H, Lq, D); k, v: (B, H, Lk, D) (kv heads already repeated).
    Full materialization of the (Lq, Lk) scores; returns q's dtype."""
    s = _masked_scores(q, k, causal, window)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def attention_p_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True,
                     window: int | None = None) -> torch.Tensor:
    """The bf16 kernel's rounding point, in torch, for the CPU tests (the
    port never calls it): float32 scores and softmax, the unnormalized
    probabilities exp(s - max) rounded to bf16 before P V, the row sum
    taken from them in float32. Shapes as `attention_ref`."""
    s = _masked_scores(q, k, causal, window)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), v.float())
    return (out / p.sum(-1, keepdim=True)).to(q.dtype)
