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

from repro_torch.launch import sharding as shd


def _chunk_loss(h, head_w, y):
    """The chunk's summed CE over labels >= 0, and their count."""
    logits = shd.constrain(h @ shd.fsdp_weight(head_w), "logits").float()
    lse = _logsumexp(logits)
    mask = y >= 0
    gold = _gold(logits, y.clamp(min=0).long())
    ce = torch.where(mask, lse - gold, torch.zeros_like(lse))
    return ce.sum(), mask.sum()


def _logsumexp(logits):
    """logsumexp over the vocab. Where the vocab is split over ranks it is
    taken shard-locally around the max across shards, so only (B, C)
    partial sums cross them (DTensor's own gathers the whole vocab)."""
    if shd.split_ways(logits, -1) <= 1:
        return torch.logsumexp(logits, -1)
    m = shd.replicate(logits.amax(-1, keepdim=True).detach(), dims=())
    return (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True)))[..., 0]


def _gold(logits, y):
    """logits[..., y]: a gather (one index a row, so its backward adds one
    term a position). Where the vocab dim is sharded (a DTensor on a
    mesh) it is the masked sum over the vocab instead, whose partial sums
    one all-reduce settles: the same values, since each sum has one
    non-zero term. (DTensor's own masked gather cannot be reduced for
    these shapes.)"""
    if not shd.split_ways(logits, -1):
        return logits.gather(-1, y[..., None])[..., 0]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    hit = vocab == y[..., None]
    return shd.replicate(torch.where(hit, logits, 0.0).sum(-1), dims=())


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
