"""Sequence-chunked cross-entropy, as `repro.models.loss` has it.

The (B, S, V) logits of a 200k vocabulary do not fit beside a model's
state, so the sequence is walked in chunks: each chunk's logits and its
CE are computed under `torch.utils.checkpoint` (the reference's
`jax.checkpoint`), so only the (B, S, d) hidden states stay resident and
the backward recomputes one chunk's logits at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_loss(h, head_w, y):
    """The chunk's summed CE over labels >= 0, and their count."""
    logits = (h @ head_w).float()                 # (B, C, V)
    lse = torch.logsumexp(logits, -1)
    mask = y >= 0
    # one index a row: the gather's backward adds one term a position
    gold = logits.gather(-1, y.clamp(min=0).long()[..., None])[..., 0]
    ce = torch.where(mask, lse - gold, torch.zeros_like(lse))
    return ce.sum(), mask.sum()


def chunked_ce(hidden: torch.Tensor, head_w: torch.Tensor,
               labels: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """hidden: (B, S, d); head_w: (d, V); labels: (B, S) integers, those
    below 0 ignored. Returns the mean token CE in float32 (0 when no label
    counts): chunks of min(chunk, S), S padded with ignored labels, the
    chunk totals summed in float32 in chunk order."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    remat = torch.is_grad_enabled() and (hidden.requires_grad
                                         or head_w.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for c0 in range(0, s + pad, chunk):
        args = (hidden[:, c0:c0 + chunk], head_w, labels[:, c0:c0 + chunk])
        c_tot, c_cnt = checkpoint(_chunk_loss, *args, use_reentrant=False) \
            if remat else _chunk_loss(*args)
        tot = tot + c_tot
        cnt = cnt + c_cnt
    return tot / cnt.clamp(min=1).float()
