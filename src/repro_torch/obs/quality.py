"""Online prediction scorecard: were the predictions *right*?
(DESIGN.md §17.)

The paper's safety argument rests on prediction quality — criticality
and P95-bucket predictions gate how hard admission oversubscribes —
yet counting decisions says nothing about whether those predictions
held. This module joins the predictions recorded at admission
(criticality, P95 bucket, per-head confidence) against realized
outcomes (the ground-truth columns `sim.telemetry.ArrivalBatch`
carries for evaluation, and the emergency plane's throttle counters)
into:

  * rolling confusion matrices over the *used* (post confidence-gate)
    decisions — the operational accuracy the admission path actually
    ran on;
  * the same high-confidence confusion over the *raw* head outputs,
    shaped exactly like `core.forest.evaluate` so the online scorecard
    reconciles with offline Table-III scoring on the same trace
    (asserted in tests);
  * calibration-by-confidence-bucket (per-head reliability curves and
    an ECE summary);
  * a PSI-style drift statistic per distribution component
    (criticality predictions, P95-bucket predictions, realized P95
    buckets) against a frozen training-time reference;
  * a `model_stale` verdict the hot-swap path and the adaptive
    controller can consult to force conservative fallback
    (`serve.adaptive.gate_ratio_on_stale`).

Everything is a host-side fold of values the serving path already
materializes — scoring can never perturb a decision.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["psi", "PredictionScorecard"]

#: Drift components tracked against the reference snapshot.
COMPONENTS = ("crit_pred", "p95_pred", "p95_realized")


def psi(expected, actual, eps: float = 1e-4) -> float:
    """Population Stability Index between two count vectors.

    ``sum((a - e) * ln(a / e))`` over bucket fractions, with ``eps``
    Laplace smoothing so empty buckets stay finite. The conventional
    reading: < 0.1 stable, 0.1-0.25 drifting, > 0.25 shifted."""
    e = np.asarray(expected, np.float64)
    a = np.asarray(actual, np.float64)
    if e.shape != a.shape:
        raise ValueError(f"shape mismatch: {e.shape} vs {a.shape}")
    if e.sum() <= 0 or a.sum() <= 0:
        return 0.0
    e = e / e.sum() + eps
    a = a / a.sum() + eps
    e, a = e / e.sum(), a / a.sum()
    return float(np.sum((a - e) * np.log(a / e)))


class _Head:
    """One prediction head's online stats (criticality or P95
    bucket): used-decision and raw high-confidence confusion, plus
    confidence-binned calibration."""

    def __init__(self, n_classes: int, gate: float, n_conf_bins: int):
        self.n_classes = n_classes
        self.gate = gate
        self.n_conf_bins = n_conf_bins
        self.reset()

    def reset(self) -> None:
        self.used_cm = np.zeros((self.n_classes,) * 2, np.int64)
        self.hi_cm = np.zeros((self.n_classes,) * 2, np.int64)
        self.n_total = 0
        self.n_hi = 0
        # calibration over RAW predictions: per confidence bin,
        # (count, sum conf, correct)
        self.bin_n = np.zeros(self.n_conf_bins, np.int64)
        self.bin_conf = np.zeros(self.n_conf_bins, np.float64)
        self.bin_correct = np.zeros(self.n_conf_bins, np.int64)

    def record(self, true, used, raw=None, conf=None) -> None:
        true = np.asarray(true, np.int64).ravel()
        used = np.asarray(used, np.int64).ravel()
        np.add.at(self.used_cm, (true, used), 1)
        self.n_total += len(true)
        if raw is None:
            return
        raw = np.asarray(raw, np.int64).ravel()
        if conf is None:
            return
        conf = np.asarray(conf, np.float64).ravel()
        hi = conf >= self.gate
        self.n_hi += int(hi.sum())
        np.add.at(self.hi_cm, (true[hi], raw[hi]), 1)
        bins = np.clip((conf * self.n_conf_bins).astype(np.int64), 0,
                       self.n_conf_bins - 1)
        np.add.at(self.bin_n, bins, 1)
        np.add.at(self.bin_conf, bins, conf)
        np.add.at(self.bin_correct, bins, (raw == true).astype(np.int64))

    @property
    def accuracy(self) -> float:
        n = self.used_cm.sum()
        return float(np.trace(self.used_cm) / n) if n else float("nan")

    @property
    def ece(self) -> float:
        """Expected calibration error over the raw-head confidence
        bins: sum_b (n_b/N) |acc_b - conf_b| (NaN before any scored
        confidence)."""
        n = self.bin_n.sum()
        if n == 0:
            return float("nan")
        mask = self.bin_n > 0
        acc = self.bin_correct[mask] / self.bin_n[mask]
        conf = self.bin_conf[mask] / self.bin_n[mask]
        return float(np.sum(self.bin_n[mask] / n * np.abs(acc - conf)))

    def offline_style(self) -> dict:
        """`core.forest.evaluate`-shaped dict from the online
        counters: pct/accuracy over high-confidence raw predictions
        and per-class recall/precision among them."""
        out = {"pct_high_conf": self.n_hi / self.n_total
               if self.n_total else float("nan"),
               "accuracy_high_conf": float(
                   np.trace(self.hi_cm) / self.n_hi)
               if self.n_hi else float("nan"),
               "buckets": {}}
        for c in range(self.n_classes):
            if self.hi_cm[c].sum() == 0 and self.hi_cm[:, c].sum() == 0:
                continue
            tp = int(self.hi_cm[c, c])
            fn = int(self.hi_cm[c].sum()) - tp
            fp = int(self.hi_cm[:, c].sum()) - tp
            out["buckets"][c] = {"recall": tp / max(tp + fn, 1),
                                 "precision": tp / max(tp + fp, 1)}
        return out


class PredictionScorecard:
    """Online predicted-vs-realized scorecard with drift detection.

    `record` folds a batch of scored arrivals in (vectorized); the
    first ``reference_n`` scored arrivals freeze into the drift
    reference unless `set_reference` installed a training-time
    snapshot explicitly. `model_stale` goes True once enough arrivals
    are scored and either a drift component's PSI crosses
    ``stale_psi`` or the used-decision criticality accuracy falls
    under ``stale_accuracy`` — the conservative-fallback signal
    exported as the ``quality_model_stale`` gauge."""

    def __init__(self, registry=None, confidence_gate: float = 0.6,
                 n_conf_bins: int = 10, reference_n: int = 256,
                 stale_psi: float = 0.25, stale_accuracy: float = 0.5,
                 min_scored: int = 64):
        if not 0.0 <= confidence_gate <= 1.0:
            raise ValueError(
                f"confidence_gate must be in [0, 1], got "
                f"{confidence_gate}")
        if min_scored < 1:
            raise ValueError(f"min_scored must be >= 1, got {min_scored}")
        self.registry = registry
        self.confidence_gate = float(confidence_gate)
        self.reference_n = int(reference_n)
        self.stale_psi = float(stale_psi)
        self.stale_accuracy = float(stale_accuracy)
        self.min_scored = int(min_scored)
        self.crit = _Head(2, self.confidence_gate, n_conf_bins)
        self.bucket = _Head(4, self.confidence_gate, n_conf_bins)
        self._ref: dict | None = None    # component -> counts
        self._ref_frozen_explicit = False
        self._cur = {c: np.zeros(4 if c != "crit_pred" else 2, np.int64)
                     for c in COMPONENTS}
        # throttle-outcome join (emergency sweeps)
        self.alarms_seen = 0
        self.samples_seen = 0
        self.cut_watts_seen = 0.0

    # -- recording ---------------------------------------------------------
    @property
    def n_scored(self) -> int:
        """Arrivals scored against ground truth so far."""
        return self.crit.n_total

    def record(self, true_crit, true_bucket, crit_used, bucket_used,
               crit_raw=None, crit_conf=None, bucket_raw=None,
               bucket_conf=None, conservative=None) -> None:
        """Fold one batch of scored arrivals in (scalars or arrays).

        ``*_used`` are the post-confidence-gate values the admission
        path ran on; ``*_raw``/``*_conf`` are the ungated head outputs
        (None when the caller has no confidences — the sim channel),
        which feed the calibration bins and the
        `core.forest.evaluate`-style reconciliation counters."""
        self.crit.record(true_crit, crit_used, crit_raw, crit_conf)
        self.bucket.record(true_bucket, bucket_used, bucket_raw,
                           bucket_conf)
        cp = np.asarray(crit_used if crit_raw is None else crit_raw,
                        np.int64).ravel()
        bp = np.asarray(bucket_used if bucket_raw is None else bucket_raw,
                        np.int64).ravel()
        tb = np.asarray(true_bucket, np.int64).ravel()
        self._cur["crit_pred"] += np.bincount(cp, minlength=2)[:2]
        self._cur["p95_pred"] += np.bincount(bp, minlength=4)[:4]
        self._cur["p95_realized"] += np.bincount(tb, minlength=4)[:4]
        if self._ref is None and self.n_scored >= self.reference_n:
            self._ref = {c: v.copy() for c, v in self._cur.items()}
        self._export()

    def observe_alarms(self, alarms: int, cut_w: float = 0.0,
                       samples: int = 0) -> None:
        """Join one emergency sweep's throttle outcome in — the
        realized-pressure context of the drift verdict."""
        self.alarms_seen += int(alarms)
        self.samples_seen += int(samples)
        self.cut_watts_seen += float(cut_w)
        self._export()

    def set_reference(self, crit_counts, p95_pred_counts,
                      p95_realized_counts) -> None:
        """Install the training-snapshot distributions PSI drifts
        against (per-component count vectors: (2,), (4,), (4,))."""
        ref = {"crit_pred": np.asarray(crit_counts, np.float64),
               "p95_pred": np.asarray(p95_pred_counts, np.float64),
               "p95_realized": np.asarray(p95_realized_counts,
                                          np.float64)}
        for c, v in ref.items():
            want = 2 if c == "crit_pred" else 4
            if v.shape != (want,):
                raise ValueError(
                    f"{c} reference must have shape ({want},), got "
                    f"{v.shape}")
        self._ref = ref
        self._ref_frozen_explicit = True

    def on_hot_swap(self) -> None:
        """Reset the per-model stats after a model hot-swap: the old
        model's confusion/calibration/drift say nothing about the
        newly installed one. An explicitly installed reference
        survives only until the swap too — the retrain ships a new
        training snapshot (re-`set_reference` it, or let the first
        ``reference_n`` scored arrivals re-freeze)."""
        self.crit.reset()
        self.bucket.reset()
        self._ref = None
        self._ref_frozen_explicit = False
        for c in self._cur:
            self._cur[c][:] = 0
        self._export()

    # -- verdicts ----------------------------------------------------------
    @property
    def crit_accuracy(self) -> float:
        """Used-decision criticality accuracy (NaN before any score)."""
        return self.crit.accuracy

    @property
    def p95_accuracy(self) -> float:
        """Used-decision P95-bucket accuracy (NaN before any score).
        This is the *measured* counterpart of the constant the sim's
        `PredictionChannel.p95_accuracy` assumes."""
        return self.bucket.accuracy

    @property
    def throttle_rate(self) -> float:
        """Alarms per emergency sample consumed (0 before any)."""
        return self.alarms_seen / max(self.samples_seen, 1)

    def drift(self) -> dict:
        """Per-component PSI vs the reference (all 0.0 before the
        reference freezes)."""
        if self._ref is None:
            return {c: 0.0 for c in COMPONENTS}
        return {c: psi(self._ref[c], self._cur[c]) for c in COMPONENTS}

    @property
    def model_stale(self) -> bool:
        """Conservative-fallback verdict: enough arrivals scored AND
        (drift past ``stale_psi`` on any component, or used criticality
        accuracy under ``stale_accuracy``)."""
        if self.n_scored < self.min_scored:
            return False
        if max(self.drift().values()) > self.stale_psi:
            return True
        acc = self.crit_accuracy
        return not math.isnan(acc) and acc < self.stale_accuracy

    def offline_style(self, head: str = "crit") -> dict:
        """`core.forest.evaluate`-shaped dict for one head ('crit' or
        'bucket') from the online high-confidence counters — the
        reconciliation surface against offline Table-III scoring."""
        if head not in ("crit", "bucket"):
            raise ValueError(f"head must be 'crit' or 'bucket', "
                             f"got {head!r}")
        return (self.crit if head == "crit" else
                self.bucket).offline_style()

    # -- export ------------------------------------------------------------
    def _export(self) -> None:
        if self.registry is None:
            return
        reg = self.registry
        reg.gauge("quality_scored",
                  help="arrivals scored against ground truth").set(
                      self.n_scored)
        acc = self.crit_accuracy
        if not math.isnan(acc):
            reg.gauge("quality_crit_accuracy",
                      help="used-decision criticality accuracy").set(acc)
        acc = self.p95_accuracy
        if not math.isnan(acc):
            reg.gauge("quality_p95_accuracy",
                      help="used-decision P95-bucket accuracy").set(acc)
        for head, h in (("crit", self.crit), ("bucket", self.bucket)):
            e = h.ece
            if not math.isnan(e):
                reg.gauge("quality_ece",
                          help="expected calibration error, by head",
                          head=head).set(e)
        for comp, v in self.drift().items():
            reg.gauge("quality_psi",
                      help="population stability index vs the training "
                      "reference, by component", component=comp).set(v)
        reg.gauge("quality_model_stale",
                  help="1 when the scorecard demands conservative "
                  "fallback").set(1.0 if self.model_stale else 0.0)

    def summary(self) -> dict:
        """JSON-ready scorecard view for the monitor (NaN reads — no
        data yet — become None so the snapshot stays strict JSON)."""
        def _f(x):
            return None if math.isnan(x) else x
        return {
            "n_scored": self.n_scored,
            "crit_accuracy": _f(self.crit_accuracy),
            "p95_accuracy": _f(self.p95_accuracy),
            "crit_confusion": self.crit.used_cm.tolist(),
            "p95_confusion": self.bucket.used_cm.tolist(),
            "ece": {"crit": _f(self.crit.ece),
                    "bucket": _f(self.bucket.ece)},
            "drift": self.drift(),
            "reference_frozen": self._ref is not None,
            "model_stale": self.model_stale,
            "alarms_seen": self.alarms_seen,
            "samples_seen": self.samples_seen,
            "cut_watts_seen": self.cut_watts_seen,
            "throttle_rate": self.throttle_rate,
        }
