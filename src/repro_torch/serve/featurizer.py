"""Device-resident twin of `core/features.py` (serve-pipeline stage 1),
the torch counterpart of `repro.serve.featurizer`.

The aggregates live as tensors indexed by subscription id —
`SubscriptionTable` holds running *sums* (not means), so ingesting newly
labeled VMs is one order-fixed segment sum over the columns and
featurizing an arrival micro-batch is one gather plus a few elementwise
ops. Feature order matches `core.features.FEATURE_NAMES` exactly.

`shard_table` partitions the rows over a mesh of devices
(`serve.sharding.shard_mesh`): a `ShardedTable` of equal row blocks, one
on each device, which `update_table`, `featurize` and `featurize_batch`
take as they take a table on one device, with the same sums and
features.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import features as F
from repro_torch.device import resolve_device
from repro_torch.serve._segments import segment_sums
from repro_torch.sim.telemetry import (
    VM_TYPES, ArrivalBatch, Population, arrival_batch)

N_FEATURES = len(F.FEATURE_NAMES)
N_VM_TYPES = len(VM_TYPES)

#: `core.features._DEFAULT_AGG` as a flat row for unseen subscriptions.
_DEFAULT_ROW = np.array(
    [F._DEFAULT_AGG["pct_uf"], F._DEFAULT_AGG["pct_7d"],
     F._DEFAULT_AGG["total"], *F._DEFAULT_AGG["bucket_mix"],
     F._DEFAULT_AGG["avg_avg"], F._DEFAULT_AGG["avg_p95"]], np.float32)


class SubscriptionTable(NamedTuple):
    """Running per-subscription sums (float32 tensors, capacity rows).
    Means are formed at featurize time, so an update is a pure add."""
    count: torch.Tensor          # (N,) — VMs observed
    uf_sum: torch.Tensor         # (N,) — sum of criticality labels
    lived7d_sum: torch.Tensor    # (N,) — sum of lifetime >= 168 h
    bucket_sum: torch.Tensor     # (N, 4) — P95-bucket histogram
    avg_util_sum: torch.Tensor   # (N,)
    p95_util_sum: torch.Tensor   # (N,)

    @property
    def capacity(self) -> int:
        return self.count.shape[0]


def empty_table(capacity: int, device=None) -> SubscriptionTable:
    """Fresh all-zero table with `capacity` subscription rows."""
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return SubscriptionTable(z(capacity), z(capacity), z(capacity),
                             z(capacity, F.N_UTIL_BUCKETS), z(capacity),
                             z(capacity))


class ShardedTable(NamedTuple):
    """A `SubscriptionTable` row-partitioned over a mesh (`shard_table`):
    `blocks[i]` holds rows ``[i * rows, (i + 1) * rows)`` on mesh position
    i's device."""
    blocks: tuple

    @property
    def capacity(self) -> int:
        return sum(b.capacity for b in self.blocks)


def shard_table(table: SubscriptionTable, mesh) -> ShardedTable:
    """Row-partition the table over a mesh of N devices: its capacity
    padded with zero rows up to a multiple of N, and each block of
    capacity/N rows copied to its position's device.

    As in the reference, the capacity is the padded one, so ids in [old
    capacity, padded capacity) become valid rows: `featurize` serves them
    the unseen-subscription defaults until ingested (they start all-zero),
    and `update_table` stores them rather than dropping them. Size the
    original capacity for the id space and the window is never reached."""
    mesh = tuple(torch.device(d) for d in mesh)
    n = len(mesh)
    cap = -(-table.capacity // n) * n
    rows = cap // n

    def pad(a):
        return torch.cat([a, a.new_zeros((cap - a.shape[0],) + a.shape[1:])])
    padded = SubscriptionTable(*(pad(a) for a in table))
    return ShardedTable(tuple(
        SubscriptionTable(*(a[i * rows:(i + 1) * rows].to(d, copy=True)
                            for a in padded))
        for i, d in enumerate(mesh)))


def _device(table) -> torch.device:
    """The device a table's callers put its operands on: its own, or its
    first block's."""
    return (table.blocks[0] if isinstance(table, ShardedTable)
            else table).count.device


def p95_bucket_torch(p95_util: torch.Tensor) -> torch.Tensor:
    """Torch twin of `repro.serve.featurizer.p95_bucket_jnp`
    (0-25/26-50/51-75/76-100, percent).

    The host's `(x - 1e-9) // 25` epsilon underflows in float32;
    `ceil(x/25) - 1` encodes the same half-open-below boundary exactly.
    The divisor is a device tensor so the card divides, rather than
    multiplying by a rounded reciprocal."""
    q = p95_util / p95_util.new_full((), 25.0)
    return torch.clamp(torch.ceil(q) - 1, 0, F.N_UTIL_BUCKETS - 1).long()


def update_table(table, subscription: torch.Tensor, uf_label: torch.Tensor,
                 lifetime_hours: torch.Tensor, p95_util: torch.Tensor,
                 avg_util: torch.Tensor):
    """Ingest a batch of labeled VMs (the label-bootstrap loop of paper
    §III-B, run incrementally). All args (B,), percent units. Ids outside
    [0, capacity) are dropped, as XLA drops out-of-range scatter rows:
    they add a zero to row 0. The sums are order-fixed
    (`serve._segments.segment_sums`), so the same history gives the same
    table on every run. A `ShardedTable` updates each block, on its
    device, with the rows whose ids it holds, in input order: the sums a
    table on one device makes."""
    if isinstance(table, ShardedTable):
        return ShardedTable(tuple(_update_block(
            blk, i * blk.capacity, subscription, uf_label, lifetime_hours,
            p95_util, avg_util) for i, blk in enumerate(table.blocks)))
    sub = subscription.long()
    keep = (sub >= 0) & (sub < table.capacity)
    sub = torch.where(keep, sub, 0)
    w = keep.float()
    bucket = torch.nn.functional.one_hot(
        p95_bucket_torch(p95_util), F.N_UTIL_BUCKETS).float()
    vals = torch.cat([torch.stack([
        w, uf_label.float() * w, (lifetime_hours >= 168).float() * w], -1),
        bucket * w[:, None],
        torch.stack([avg_util.float() * w, p95_util.float() * w], -1)], -1)
    base = torch.cat([torch.stack(
        [table.count, table.uf_sum, table.lived7d_sum], -1),
        table.bucket_sum, torch.stack(
            [table.avg_util_sum, table.p95_util_sum], -1)], -1)
    out = segment_sums(base, sub, vals)
    nb = F.N_UTIL_BUCKETS
    return SubscriptionTable(
        count=out[:, 0].contiguous(), uf_sum=out[:, 1].contiguous(),
        lived7d_sum=out[:, 2].contiguous(),
        bucket_sum=out[:, 3:3 + nb].contiguous(),
        avg_util_sum=out[:, 3 + nb].contiguous(),
        p95_util_sum=out[:, 4 + nb].contiguous())


def _update_block(blk: SubscriptionTable, lo: int, subscription, *cols):
    """`update_table` on the block of rows ``[lo, lo + capacity)``: the
    batch's rows with ids there, at their local ids."""
    dev = blk.count.device
    sub = subscription.long().to(dev)
    mine = (sub >= lo) & (sub < lo + blk.capacity)
    return update_table(blk, sub[mine] - lo,
                        *(c.to(dev)[mine] for c in cols))


def ingest_population(table, history: Population, uf_labels):
    """Fold a labeled population into the aggregates (one update)."""
    b = arrival_batch(history)
    avg = np.array([v.avg_util for v in history.vms], np.float32)
    dev = _device(table)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)
    return update_table(table, t(b.subscription),
                        t(np.asarray(uf_labels, np.float32)),
                        t(b.lifetime_hours), t(b.p95_util), t(avg))


def table_from_history(history: Population, uf_labels, capacity: int,
                       device=None) -> SubscriptionTable:
    """Bulk-load a table from an offline labeled history."""
    return ingest_population(empty_table(capacity, device), history,
                             uf_labels)


def _rows(table, sub: torch.Tensor) -> SubscriptionTable:
    """The table's rows of ids `sub` (each in [0, capacity)), on `sub`'s
    device. A `ShardedTable` gathers each block's ids on its device and
    selects them into place."""
    if not isinstance(table, ShardedTable):
        return SubscriptionTable(*(a[sub] for a in table))
    out = None
    for i, blk in enumerate(table.blocks):
        lo = i * blk.capacity
        local = (sub - lo).to(blk.count.device)
        got = SubscriptionTable(*(
            a[local.clamp(0, blk.capacity - 1)].to(sub.device)
            for a in blk))
        if out is None:
            out = got
            continue
        mine = (sub >= lo) & (sub < lo + blk.capacity)
        out = SubscriptionTable(*(
            torch.where(mine.view(-1, *([1] * (g.ndim - 1))), g, o)
            for g, o in zip(got, out)))
    return out


def featurize(table, subscription: torch.Tensor, cores: torch.Tensor,
              memory_gb: torch.Tensor,
              vm_type_idx: torch.Tensor) -> torch.Tensor:
    """(B,) arrival columns -> (B, len(FEATURE_NAMES)) float32 on their
    device, same layout as `core.features.build_features`. Unseen
    subscriptions, including ids outside [0, capacity), fall back to the
    offline path's default aggregates."""
    sub = subscription.long()
    in_range = (sub >= 0) & (sub < table.capacity)
    sub = torch.where(in_range, sub, 0)
    rows = _rows(table, sub)
    cnt = rows.count                                         # (B,)
    seen = in_range & (cnt > 0)
    denom = torch.clamp(cnt, min=1.0)
    aggs = torch.stack([rows.uf_sum / denom, rows.lived7d_sum / denom, cnt],
                       -1)
    bucket_mix = rows.bucket_sum / denom[:, None]            # (B, 4)
    util = torch.stack([rows.avg_util_sum / denom,
                        rows.p95_util_sum / denom], -1)
    agg_row = torch.cat([aggs, bucket_mix, util], -1)        # (B, 9)
    default = torch.as_tensor(_DEFAULT_ROW, device=agg_row.device)
    agg_row = torch.where(seen[:, None], agg_row, default[None])
    onehot = torch.nn.functional.one_hot(vm_type_idx.long(),
                                         N_VM_TYPES).float()
    return torch.cat([agg_row, cores[:, None].float(),
                      memory_gb[:, None].float(), onehot], -1)


def featurize_batch(table, batch: ArrivalBatch, pad_to: int | None = None,
                    device=None) -> torch.Tensor:
    """Featurize one micro-batch on `device` (None: the table's, a
    `ShardedTable`'s first block's), optionally padded to a fixed batch
    size (padding rows use subscription 0 / type 0 and are dropped by the
    caller)."""
    n = len(batch) if pad_to is None else pad_to
    dev = _device(table) if device is None else torch.device(device)

    def col(a):
        out = np.zeros(n, np.asarray(a).dtype)
        out[:len(a)] = a
        return torch.as_tensor(out, device=dev)
    return featurize(table, col(batch.subscription), col(batch.cores),
                     col(batch.memory_gb), col(batch.vm_type_idx))
