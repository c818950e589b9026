"""Resource-Central-style prediction service (paper §II-D, §III-B).

Bundles the criticality classifier and the *two-stage* P95-utilization
model behind one query interface with confidence gating:

  * criticality: binary user-facing / non-user-facing forest;
  * P95 utilization: stage 1 predicts whether P95 > 50 %; stage 2 routes
    to a low-bucket forest (buckets 0-1) or high-bucket forest (buckets
    2-3), each trained only on examples stage 1 predicts with >= 60 %
    confidence (paper §III-B "Utilization prediction").

The scheduler discards low-confidence predictions and conservatively
assumes user-facing @ 100 % P95 (paper §IV-B).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.forest import (
    ObliviousForest, train_gradient_boosting, train_random_forest)

CONFIDENCE_GATE = 0.6
UF, NUF = 1, 0          # workload-type encoding (bucket 2 in Table III = UF)


@dataclass
class TwoStageP95Model:
    stage1: ObliviousForest          # P95 > 50% ?
    low: ObliviousForest             # buckets {0, 1}
    high: ObliviousForest            # buckets {2, 3}

    def predict(self, x: np.ndarray):
        """Returns (bucket (B,), confidence (B,))."""
        s1, c1 = self.stage1.predict_np(x)
        lo_b, lo_c = self.low.predict_np(x)
        hi_b, hi_c = self.high.predict_np(x)
        bucket = np.where(s1 == 1, hi_b + 2, lo_b)
        conf = np.minimum(c1, np.where(s1 == 1, hi_c, lo_c))
        return bucket, conf


@dataclass
class PredictionService:
    criticality: ObliviousForest
    p95: TwoStageP95Model
    confidence_gate: float = CONFIDENCE_GATE

    def query(self, x: np.ndarray):
        """x: (B, F) features. Returns dict of arrays:
        workload_type (UF/NUF), p95_bucket (0..3), and the conservative
        post-gating values the scheduler actually uses."""
        wt, wt_conf = self.criticality.predict_np(x)
        pb, pb_conf = self.p95.predict(x)
        wt_used = np.where(wt_conf >= self.confidence_gate, wt, UF)
        pb_used = np.where(pb_conf >= self.confidence_gate, pb, 3)
        return {"workload_type": wt, "workload_conf": wt_conf,
                "p95_bucket": pb, "p95_conf": pb_conf,
                "workload_type_used": wt_used, "p95_bucket_used": pb_used}


def bucket_to_p95(bucket: np.ndarray) -> np.ndarray:
    """Bucket midpoint as the utilization estimate (fraction 0-1)."""
    return (np.asarray(bucket) * 25.0 + 12.5) / 100.0


def train_service(x: np.ndarray, uf_labels: np.ndarray,
                  p95_buckets: np.ndarray, model: str = "rf",
                  seed: int = 0, n_trees: int = 48) -> PredictionService:
    """Train the full service. `model` in {'rf', 'gb'} (Table III)."""
    trainer = train_random_forest if model == "rf" else \
        train_gradient_boosting
    crit = trainer(x, uf_labels.astype(np.int64), 2, n_trees=n_trees,
                   seed=seed)

    over50 = (p95_buckets >= 2).astype(np.int64)
    stage1 = trainer(x, over50, 2, n_trees=n_trees, seed=seed + 1)
    _, conf1 = stage1.predict_np(x)
    hi_conf = conf1 >= CONFIDENCE_GATE          # paper: train stage 2 on
    lo_mask = hi_conf & (p95_buckets < 2)       # high-confidence stage-1
    hi_mask = hi_conf & (p95_buckets >= 2)      # examples only
    low = trainer(x[lo_mask], p95_buckets[lo_mask], 2,
                  n_trees=n_trees, seed=seed + 2)
    high = trainer(x[hi_mask], p95_buckets[hi_mask] - 2, 2,
                   n_trees=n_trees, seed=seed + 3)
    return PredictionService(crit, TwoStageP95Model(stage1, low, high))

