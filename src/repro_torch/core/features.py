"""Arrival-time feature extraction for the criticality & P95 models.

Paper §III-B lists the features, all available when a VM arrives:
subscription aggregates (percent user-facing, percent long-lived, VM
count, utilization-bucket mix, average of avg / P95 utilizations) plus
the arriving VM's cores, memory and type. We compute subscription
aggregates from the *historical* population (VMs observed before the
arrival), labeled by the criticality pattern-matching algorithm — exactly
the label-bootstrapping loop the paper uses.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sim.telemetry import VM_TYPES, Population

N_UTIL_BUCKETS = 4

FEATURE_NAMES = (
    ["sub_pct_user_facing", "sub_pct_lived_7d", "sub_total_vms"]
    + [f"sub_pct_util_bucket_{i}" for i in range(N_UTIL_BUCKETS)]
    + ["sub_avg_of_avg_util", "sub_avg_of_p95_util", "vm_cores",
       "vm_memory_gb"]
    + [f"vm_type_{t}" for t in VM_TYPES])


def p95_bucket(p95_util: np.ndarray) -> np.ndarray:
    """Paper buckets: 0-25, 26-50, 51-75, 76-100 (percent)."""
    return np.clip((np.asarray(p95_util) - 1e-9) // 25, 0,
                   N_UTIL_BUCKETS - 1).astype(np.int64)


def subscription_aggregates(history: Population,
                            uf_labels: np.ndarray) -> dict:
    """Per-subscription aggregates from historical VMs. `uf_labels` are
    the criticality-algorithm labels for history.vms (same order)."""
    aggs: dict[int, dict] = {}
    by_sub: dict[int, list] = {}
    for i, vm in enumerate(history.vms):
        by_sub.setdefault(vm.subscription, []).append(i)
    for sub, idxs in by_sub.items():
        vms = [history.vms[i] for i in idxs]
        labels = uf_labels[idxs]
        buckets = p95_bucket(np.array([v.p95_util for v in vms]))
        aggs[sub] = {
            "pct_uf": float(labels.mean()),
            "pct_7d": float(np.mean([v.lifetime_hours >= 168
                                     for v in vms])),
            "total": float(len(vms)),
            "bucket_mix": np.bincount(buckets, minlength=N_UTIL_BUCKETS)
            / len(vms),
            "avg_avg": float(np.mean([v.avg_util for v in vms])),
            "avg_p95": float(np.mean([v.p95_util for v in vms])),
        }
    return aggs


_DEFAULT_AGG = {"pct_uf": 0.5, "pct_7d": 0.2, "total": 0.0,
                "bucket_mix": np.full(N_UTIL_BUCKETS, 1 / N_UTIL_BUCKETS),
                "avg_avg": 30.0, "avg_p95": 50.0}


def build_features(arrivals: Population, aggs: dict) -> np.ndarray:
    """(n_arrivals, len(FEATURE_NAMES)) float32 feature matrix."""
    rows = []
    type_idx = {t: i for i, t in enumerate(VM_TYPES)}
    for vm in arrivals.vms:
        a = aggs.get(vm.subscription, _DEFAULT_AGG)
        onehot = np.zeros(len(VM_TYPES))
        onehot[type_idx[vm.vm_type]] = 1.0
        rows.append(np.concatenate([
            [a["pct_uf"], a["pct_7d"], a["total"]], a["bucket_mix"],
            [a["avg_avg"], a["avg_p95"], float(vm.cores),
             float(vm.memory_gb)], onehot]))
    return np.asarray(rows, np.float32)


def split_history_arrivals(pop: Population, history_frac: float = 0.5):
    """Deterministic temporal split: earlier VMs are history (features
    source), later VMs are arrivals (training/eval examples)."""
    n_hist = int(len(pop.vms) * history_frac)
    hist = Population(vms=pop.vms[:n_hist])
    arr = Population(vms=pop.vms[n_hist:])
    return hist, arr
