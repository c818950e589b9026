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


#: Digit bits of the long-series path's selects: the selection's, over
#: the deviations' bits 30..0, and the medians' past WALK_REPS (a 32-bin
#: histogram a warp).
SELECT_BITS, MEDIAN_BITS = 8, 5
#: Columns of at most this many repetitions (T <= 6,144) take the block
#: path's register walk for their medians, longer ones the digit select.
WALK_REPS = 128


def _digit_select(keys, valid, rank, hi, prefix, bits):
    """The long-series path's exact select, emulated on rows of int64
    `keys` in [0, 2^32) of which `valid` count: the `rank`-th smallest
    (1-based) by digits of `bits` bits from bit `hi` down, starting under
    `prefix` (the bits above `hi` every valid key shares). A round counts
    the keys under the prefix into the bins of bits [max(hi - bits + 1,
    0), hi], takes the bin where the counts reach the rank, and a row
    stops when that bin holds one key or its last bit is set (a row with
    no valid key takes no round). Returns the bin's first key and last
    key, the count under it and in it, and the rounds taken."""
    n = keys.shape[0]
    below = torch.zeros(n, dtype=torch.int64)
    count = torch.zeros(n, dtype=torch.int64)
    lo = torch.zeros(n, dtype=torch.int64)
    rounds = torch.zeros(n, dtype=torch.int64)
    live = valid.any(1)
    hi = hi.clone()
    prefix = prefix.clone()
    while bool(live.any()):
        lo = torch.where(live, (hi - bits + 1).clamp(min=0), lo)
        above = ((1 << 32) - 1) ^ ((1 << (hi + 1)) - 1)
        match = valid & ((keys & above[:, None]) == prefix[:, None])
        digit = (keys >> lo[:, None]) & ((2 << (hi - lo)) - 1)[:, None]
        hist = torch.zeros(n, 1 << bits, dtype=torch.int64).scatter_add_(
            1, digit, match.long())
        cum = hist.cumsum(1)
        d = (cum < (rank - below)[:, None]).sum(1).clamp(max=(1 << bits) - 1)
        before = cum.gather(1, d[:, None])[:, 0] - hist.gather(
            1, d[:, None])[:, 0]
        prefix = torch.where(live, prefix | (d << lo), prefix)
        below = torch.where(live, below + before, below)
        count = torch.where(live, hist.gather(1, d[:, None])[:, 0], count)
        rounds += live.long()
        live &= ~((count == 1) | (lo == 0))
        hi = torch.where(live, lo - 1, hi)
    return prefix, prefix | ((1 << lo) - 1), below, count, rounds


def smallest_k_digits(dev: torch.Tensor, k: int):
    """The long-series path's selection, emulated on the CPU (tests only):
    `dev` (B, 3, T), a row's non-negative float32 deviations (+inf
    allowed) of the three periods, whose k-th smallest the kernel selects
    in the same rounds of SELECT_BITS-bit digits of the patterns' bits
    30..0, each period stopping when its bin holds one pattern
    (`_digit_select`); v_k is then the largest pattern up to the bin's
    end. Returns v_k and the
    count under it (B, 3), the rounds the block takes (B,), the most of
    its three periods, and the sum of the k smallest (B, 3), float64:
    sum(d < v_k) + (k - below) v_k."""
    b, nq, t = dev.shape
    keys = dev.contiguous().view(torch.int32).to(torch.int64) \
        .reshape(b * nq, t)
    zero = torch.zeros(b * nq, dtype=torch.int64)
    first, last, below, _, rounds = _digit_select(
        keys, torch.ones_like(keys, dtype=torch.bool),
        torch.full_like(zero, k), zero + 30, zero, SELECT_BITS)
    vk = torch.where(keys <= last[:, None], keys, -1).amax(1)
    under = torch.where(keys < first[:, None], keys, 0).to(torch.int32) \
        .view(torch.float32).double().sum(1)
    kth = vk.to(torch.int32).view(torch.float32)
    total = under + (k - below).double() * kth.double()
    return (kth.reshape(b, nq), below.reshape(b, nq),
            rounds.reshape(b, nq).amax(1), total.reshape(b, nq))


def _slot_keys(x: torch.Tensor, period: int):
    """The order keys of each slot of `period`, (B period, n): the row in
    48 columns of T / 48 repetitions (slot i = 48 r + c in column c), a
    slot the 48 / period columns s, s + period, ..."""
    b, t = x.shape
    cols = order_keys(x).reshape(b, t // 48, 48).transpose(1, 2)
    return cols.reshape(b, 48 // period, period, t // 48).transpose(1, 2) \
        .reshape(b * period, -1)


def _top_bits(keys):
    """Each row's least key, whether it equals the largest, the highest
    bit where the two differ, and the bits above it every key shares."""
    mn, mx = keys.amin(1), keys.amax(1)
    hi = ((((mn ^ mx)[:, None] >> torch.arange(32)) > 0).sum(1) - 1) \
        .clamp(min=0)
    above = ((1 << 32) - 1) ^ ((1 << (hi + 1)) - 1)
    return mn, mn == mx, hi, mn & above


def _medians(keys, mn, flat, last, below, upto, b, period):
    """(B, period) medians from each row's lower-middle bin [.., last]
    with `below` keys under the bin and `upto` up to its end: the largest
    key up to `last` (the least key on a constant row), and for an even
    count the upper middle, the same key when more than rank + 1 lie up
    to `last`, else the least key above; the two averaged."""
    n = keys.shape[1]
    lo_key = torch.where(flat, mn, torch.where(
        keys <= last[:, None], keys, -1).amax(1))
    nxt = torch.where(keys > last[:, None], keys, 1 << 32).amin(1)
    hi_key = torch.where(flat | (upto > (n - 1) // 2 + 1), lo_key, nxt)
    lo_v, hi_v = _key_values(lo_key), _key_values(hi_key)
    med = lo_v if n % 2 else (lo_v + hi_v) * 0.5
    return med.reshape(b, period)


def slot_medians_digits(x: torch.Tensor, period: int) -> torch.Tensor:
    """The long-series path's per-slot medians past WALK_REPS repetitions a
    column, emulated on the CPU (tests only): x (B, T) -> (B, period). For
    each slot's order keys over the 48-column layout's 1 to 3 runs
    (`_slot_keys`), the lower middle (rank (n - 1) // 2) is selected by
    `_digit_select` in MEDIAN_BITS-bit digits from the highest bit where
    the least and largest keys differ (none on a constant slot); the
    middles are then taken as `_medians` says."""
    keys = _slot_keys(x, period)
    lo_r = (keys.shape[1] - 1) // 2
    mn, flat, hi, prefix = _top_bits(keys)
    _, last, below, count, _ = _digit_select(
        keys, torch.ones_like(keys, dtype=torch.bool) & ~flat[:, None],
        torch.full_like(mn, lo_r + 1), hi, prefix, MEDIAN_BITS)
    return _medians(keys, mn, flat, last, below, below + count, x.shape[0],
                    period)


def slot_medians_walk(x: torch.Tensor, period: int) -> torch.Tensor:
    """The long-series path's per-slot medians up to WALK_REPS repetitions
    a column, emulated on the CPU (tests only): x (B, T) -> (B, period).
    For each slot's order keys a radix walk from the highest bit where the
    least and largest keys differ sets the lower middle's bits (a bit is
    set while at most its rank of keys lie under the prefix with it set)
    and stops as soon as one key is left between the prefix and its next
    step; the middles are then taken as `_medians` says."""
    keys = _slot_keys(x, period)
    n = keys.shape[1]
    lo_r = (n - 1) // 2
    mn, flat, hi, prefix = _top_bits(keys)
    below = torch.zeros_like(mn)
    upto = torch.full_like(mn, n)
    stop = torch.zeros_like(mn)              # the bit the walk stopped at
    live = ~flat
    for bit in range(31, -1, -1):
        on = live & (hi >= bit)
        mid = prefix | (1 << bit)
        c = (keys < mid[:, None]).sum(1)
        low = on & (c <= lo_r)
        prefix = torch.where(low, mid, prefix)
        below = torch.where(low, c, below)
        upto = torch.where(on & ~low, c, upto)
        end = on & ((upto - below == 1) | (bit == 0))
        stop = torch.where(end, bit, stop)
        live &= ~end
    last = prefix | ((1 << stop) - 1)
    return _medians(keys, mn, flat, last, below, upto, x.shape[0], period)


def slot_medians_block(x: torch.Tensor, period: int) -> torch.Tensor:
    """The long-series path's per-slot medians as the kernel takes them:
    `slot_medians_walk` up to WALK_REPS repetitions a column, else
    `slot_medians_digits`."""
    walk = x.shape[1] // 48 <= WALK_REPS
    return (slot_medians_walk if walk else slot_medians_digits)(x, period)
