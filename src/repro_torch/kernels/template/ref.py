"""Plain torch version of the criticality template kernel: the sort-based
oracle `repro_torch.core.criticality.score` (exact medians and exact
smallest-k selection by sorting), stacked to (B, 2)."""
from __future__ import annotations

import torch

from repro_torch.core import criticality


def criticality_scores_ref(series: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, 2) [Compare8, Compare12]."""
    s = criticality.score(series)
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
