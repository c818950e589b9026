"""Plain torch version of the criticality template kernel: the sort-based
oracle `repro_torch.core.criticality.score` (exact medians and exact
smallest-k selection by sorting), stacked to (B, 2)."""
from __future__ import annotations

import torch

from repro_torch.core import criticality


def criticality_scores_ref(series: torch.Tensor,
                           keep_frac: float = 0.8) -> torch.Tensor:
    """(B, T) -> (B, 2) [Compare8, Compare12], each deviation the mean of
    the round(keep_frac T) smallest."""
    s = criticality.score(series, keep_frac)
    return torch.stack([s.compare8, s.compare12], dim=-1)


def smallest_k_radix(dev: torch.Tensor, k: int, n_valid: int | None = None):
    """The template kernel's selection, emulated on the CPU (tests only):
    for each row of `dev` (B, N), non-negative float32 (+inf allowed) of
    which the first `n_valid` (default all) count and the rest are the
    kernel's padding past T, the radix select that sets the k-th
    smallest's bits from 30 down to 0 (a bit is set when fewer than k
    patterns lie under the prefix with it set) and stops when one
    pattern is left between the prefix and its next step. Returns the k-th smallest value, the count of values
    under it, the passes taken, and the sum of the k smallest as
    sum(d < v_k) + (k - below) v_k."""
    u = dev.contiguous().view(torch.int32).to(torch.int64)     # 0 .. 2^31
    n_valid = u.shape[1] if n_valid is None else n_valid
    u[:, n_valid:] = 2 ** 31 - 1                 # padding never counts
    rows = u.shape[0]
    prefix = torch.zeros(rows, dtype=torch.int64)
    below = torch.zeros(rows, dtype=torch.int64)
    upto = torch.full((rows,), n_valid, dtype=torch.int64)
    done = torch.zeros(rows, dtype=torch.bool)
    passes = torch.zeros(rows, dtype=torch.int64)
    for bit in range(30, -1, -1):
        live = ~done
        mid = prefix | (1 << bit)
        c = (u < mid[:, None]).sum(1)
        low = live & (c < k)
        prefix = torch.where(low, mid, prefix)
        below = torch.where(low, c, below)
        upto = torch.where(live & ~low, c, upto)
        passes += live.long()
        one = live & (upto - below == 1)
        if one.any():
            hi = prefix + (1 << bit)
            m = torch.where(u < hi[:, None], u, torch.zeros_like(u)).amax(1)
            prefix = torch.where(one, m, prefix)
            done |= one
    kth = prefix.to(torch.int32).view(torch.float32)
    lower = torch.where(u < prefix[:, None], dev, torch.zeros_like(dev))
    total = lower.sum(1) + (k - below).to(torch.float32) * kth
    return kth, below, passes, total


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 keys in [0, 2^32) that order as the floats do: the
    long-series path's bit patterns (negatives flipped whole, the sign bit
    set on the rest)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, 0xFFFFFFFF - u, u | 2 ** 31)


def _key_values(k: torch.Tensor) -> torch.Tensor:
    u = torch.where(k >= 2 ** 31, k & 0x7FFFFFFF, 0xFFFFFFFF - k)
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32) \
        .view(torch.float32)


def slot_medians_radix(x: torch.Tensor, period: int) -> torch.Tensor:
    """The long-series path's per-slot medians, emulated on the CPU (tests
    only): x (B, T) -> (B, period). For each slot, a radix select over the
    order keys of its T / period repetitions sets the lower middle value's
    bits from 31 down to 0 (a bit is set while at most its rank lie under
    the prefix with it set); for an even count the upper middle is the
    same value when more than rank + 1 lie at or under it, else the least
    key above it, and the two are averaged."""
    b, t = x.shape
    reps = t // period
    keys = order_keys(x).reshape(b, reps, period)
    lo_r = (reps - 1) // 2
    prefix = torch.zeros((b, period), dtype=torch.int64)
    for bit in range(31, -1, -1):
        mid = prefix | (1 << bit)
        c = (keys < mid[:, None]).sum(1)
        prefix = torch.where(c <= lo_r, mid, prefix)
    lo = _key_values(prefix)
    if reps % 2:
        return lo
    le = (keys <= prefix[:, None]).sum(1)
    above = torch.where(keys > prefix[:, None], keys,
                        torch.full_like(keys, 2 ** 32 - 1)).amin(1)
    hi = torch.where(le > lo_r + 1, lo, _key_values(above))
    return (lo + hi) * 0.5
