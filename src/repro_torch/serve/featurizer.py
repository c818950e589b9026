"""Device-resident twin of `core/features.py` (serve-pipeline stage 1),
the torch counterpart of `repro.serve.featurizer`.

The aggregates live as tensors indexed by subscription id —
`SubscriptionTable` holds running *sums* (not means), so ingesting newly
labeled VMs is one `index_add` per column and featurizing an arrival
micro-batch is one gather plus a few elementwise ops. Feature order
matches `core.features.FEATURE_NAMES` exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import features as F
from repro_torch.device import resolve_device
from repro_torch.sim.telemetry import (
    VM_TYPES, ArrivalBatch, Population, arrival_batch)

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


def p95_bucket_torch(p95_util: torch.Tensor) -> torch.Tensor:
    """Torch twin of `repro.serve.featurizer.p95_bucket_jnp`
    (0-25/26-50/51-75/76-100, percent).

    The host's `(x - 1e-9) // 25` epsilon underflows in float32;
    `ceil(x/25) - 1` encodes the same half-open-below boundary exactly.
    The divisor is a device tensor so the card divides, rather than
    multiplying by a rounded reciprocal."""
    q = p95_util / p95_util.new_full((), 25.0)
    return torch.clamp(torch.ceil(q) - 1, 0, F.N_UTIL_BUCKETS - 1).long()


def update_table(table: SubscriptionTable, subscription: torch.Tensor,
                 uf_label: torch.Tensor, lifetime_hours: torch.Tensor,
                 p95_util: torch.Tensor,
                 avg_util: torch.Tensor) -> SubscriptionTable:
    """Ingest a batch of labeled VMs (the label-bootstrap loop of paper
    §III-B, run incrementally). All args (B,), percent units. Ids outside
    [0, capacity) are dropped, as XLA drops out-of-range scatter rows:
    `index_add` would raise on them, so they add a zero to row 0."""
    sub = subscription.long()
    keep = (sub >= 0) & (sub < table.capacity)
    sub = torch.where(keep, sub, 0)
    w = keep.float()
    bucket = torch.nn.functional.one_hot(
        p95_bucket_torch(p95_util), F.N_UTIL_BUCKETS).float()

    def add(col, vals):
        return col.index_add(0, sub, vals)
    return SubscriptionTable(
        count=add(table.count, w),
        uf_sum=add(table.uf_sum, uf_label.float() * w),
        lived7d_sum=add(table.lived7d_sum, (lifetime_hours >= 168).float()
                        * w),
        bucket_sum=add(table.bucket_sum, bucket * w[:, None]),
        avg_util_sum=add(table.avg_util_sum, avg_util.float() * w),
        p95_util_sum=add(table.p95_util_sum, p95_util.float() * w))


def ingest_population(table: SubscriptionTable, history: Population,
                      uf_labels) -> SubscriptionTable:
    """Fold a labeled population into the aggregates (one update)."""
    b = arrival_batch(history)
    avg = np.array([v.avg_util for v in history.vms], np.float32)
    dev = table.count.device

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


def featurize(table: SubscriptionTable, subscription: torch.Tensor,
              cores: torch.Tensor, memory_gb: torch.Tensor,
              vm_type_idx: torch.Tensor) -> torch.Tensor:
    """(B,) arrival columns -> (B, len(FEATURE_NAMES)) float32, same layout as
    `core.features.build_features`. Unseen subscriptions, including ids
    outside [0, capacity), fall back to the offline path's default
    aggregates."""
    sub = subscription.long()
    in_range = (sub >= 0) & (sub < table.capacity)
    sub = torch.where(in_range, sub, 0)
    cnt = table.count[sub]                                   # (B,)
    seen = in_range & (cnt > 0)
    denom = torch.clamp(cnt, min=1.0)
    aggs = torch.stack([table.uf_sum[sub] / denom,
                        table.lived7d_sum[sub] / denom, cnt], -1)
    bucket_mix = table.bucket_sum[sub] / denom[:, None]      # (B, 4)
    util = torch.stack([table.avg_util_sum[sub] / denom,
                        table.p95_util_sum[sub] / denom], -1)
    agg_row = torch.cat([aggs, bucket_mix, util], -1)        # (B, 9)
    default = torch.as_tensor(_DEFAULT_ROW, device=agg_row.device)
    agg_row = torch.where(seen[:, None], agg_row, default[None])
    onehot = torch.nn.functional.one_hot(vm_type_idx.long(),
                                         N_VM_TYPES).float()
    return torch.cat([agg_row, cores[:, None].float(),
                      memory_gb[:, None].float(), onehot], -1)


def featurize_batch(table: SubscriptionTable, batch: ArrivalBatch,
                    pad_to: int | None = None) -> torch.Tensor:
    """Featurize one micro-batch on the table's device, optionally padded
    to a fixed batch size (padding rows use subscription 0 / type 0 and
    are dropped by the caller)."""
    n = len(batch) if pad_to is None else pad_to
    dev = table.count.device

    def col(a):
        out = np.zeros(n, np.asarray(a).dtype)
        out[:len(a)] = a
        return torch.as_tensor(out, device=dev)
    return featurize(table, col(batch.subscription), col(batch.cores),
                     col(batch.memory_gb), col(batch.vm_type_idx))
