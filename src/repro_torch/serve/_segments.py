"""Order-fixed segment sums, shared by the featurizer's table updates and
the placement's departures."""
from __future__ import annotations

import torch


def segment_sums(base: torch.Tensor, sub: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """`base` (N, K) plus the rows of `vals` (B, K) summed by row id `sub`
    (B,), each row's values added one at a time in input order — the
    order the CPU's `index_add` adds them in. A stable sort groups the
    rows, each group fills one row of a zero-padded (groups, width, K)
    block, and the block's columns are added in turn: every sum runs in
    one fixed order, so the result repeats bit for bit from run to run,
    on the card as on the CPU (the card's float `index_add` adds with
    atomics, in whatever order they land)."""
    if sub.numel() == 0:
        return base
    order = torch.sort(sub, stable=True).indices
    s, v = sub[order], vals[order]
    ids, seg, counts = torch.unique_consecutive(s, return_inverse=True,
                                                return_counts=True)
    pos = torch.arange(len(s), device=s.device) \
        - (torch.cumsum(counts, 0) - counts)[seg]
    block = v.new_zeros(len(ids), int(counts.max()), v.shape[1])
    block[seg, pos] = v
    acc = base[ids]
    for j in range(block.shape[1]):
        acc = acc + block[:, j]
    return base.index_copy(0, ids, acc)
