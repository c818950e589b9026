"""Plain torch version of the flash-attention kernel: the naive-softmax
oracle of `repro.kernels.flash_attention.ref`, float32 throughout, with
the kernel's end alignment (queries sit at the last Lq positions of the
keys) and the finite masking value NEG; and `attention_kernel_ref`,
which also gives a query that sees no key the value the reference's
kernel writes for it at its key tile `bk`."""
from __future__ import annotations

import torch

NEG = -1e30
#: Key tile of the reference's `flash_attention` at its defaults (its
#: keyword `bk`): the keys are padded to a multiple of it before the
#: kernel runs.
REF_BK = 128


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


def no_key_rows(lq: int, lk: int, causal: bool) -> int:
    """Query rows, from the first, that see no key: under a causal mask,
    with or without a window, the rows i < Lq - Lk (position i + Lk - Lq
    before the first key). A window alone always leaves a row its last
    key."""
    return max(lq - lk, 0) if causal and lk > 0 else 0


def no_key_value(v: torch.Tensor, bk: int = REF_BK) -> torch.Tensor:
    """(B, H, Lk, D) -> (B, H, D) float32: what the reference's kernel
    writes for a query that sees no key, at key tiles of `bk`. Its masked
    scores are the finite NEG, so a row whose every score is NEG keeps
    max NEG and takes exp(NEG - NEG) = 1 for every key of every key tile,
    the zero keys padding Lk to a multiple of bk among them
    (src/repro/kernels/flash_attention/flash_attention.py:52-58 and
    ops.py:28-31): the sum of v over the Lk keys over bk ceil(Lk / bk).
    The reference's oracle `attention_ref` gives the mean over Lk
    instead."""
    lk = v.shape[2]
    return v.float().sum(2) / float(bk * -(-lk // bk))


def attention_kernel_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int | None = None,
                         bk: int = REF_BK) -> torch.Tensor:
    """`attention_ref` with the rows that see no key (`no_key_rows`) set to
    `no_key_value` at key tiles of `bk`, as the reference's
    `flash_attention` writes them: the function the kernel computes.
    Shapes as `attention_ref`."""
    out = attention_ref(q, k, v, causal=causal, window=window)
    n = no_key_rows(q.shape[2], k.shape[2], causal)
    if n:
        out[:, :, :n] = no_key_value(v, bk)[:, :, None].to(out.dtype)
    return out


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
