"""Fleet observability plane, the torch port's copy of `repro.obs`
(numpy only; it imports nothing of the JAX package).

Pillars, one bundle:

  * `registry` — a host-side `MetricsRegistry` of counters, gauges,
    and log-bucketed histograms, fed by the counter outputs the
    placement/sharding/emergency steps return and exported as
    Prometheus text or a JSON snapshot.
  * `audit` — an `AuditTrail` ring recording one decision tuple per
    arrival (chosen chassis, rule, fail reason, pool state) so a
    capped critical VM can be explained post-hoc.
  * `tracer` — a `SpanTracer` timing each pipeline stage per batch
    (ingest -> merge -> featurize -> infer -> place -> commit, plus
    emergency sweeps and migrations) with a ``torch.profiler`` hook.
  * `windows` — a `WindowPlane` of watermark-aligned tumbling/rolling
    time windows and fixed-bucket histograms (`obs.windows`).
  * `quality` — a `PredictionScorecard` joining predictions recorded
    at admission against ground-truth labels and throttle outcomes:
    rolling confusion matrices, calibration, PSI drift, and the
    ``model_stale`` gauge (`obs.quality`).
  * `slo` — an `SLOMonitor` evaluating declarative budget rules with
    multi-window burn-rate alerting (`obs.slo`).
  * `recorder` — a `FlightRecorder` of the merged event stream and
    placement decisions, with deterministic incident replay
    (`obs.recorder`).

All of it lives on the host side of the device boundary: it folds
outputs the device calls already returned and never adds an input to
one, so an instrumented run is decision-bit-identical to an
uninstrumented one (asserted in ``tests/test_torch_obs_pipeline.py``).
Construct one `Observability` per pipeline and pass it as
``PlaneBundle(obs=...)`` of `serve.pipeline.ServePipeline` /
`ShardedServePipeline`, or as the ``obs=`` keyword of
`sim.scheduler_sim.simulate`; render it with `launch.monitor`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .audit import (AdaptiveRecord, AdaptiveTrail, AuditRecord,
                    AuditTrail, OUTCOME_NAMES)
from .quality import PredictionScorecard
from .recorder import FlightRecorder
from .registry import (LEVEL_NAMES, Counter, Gauge, Histogram,
                       MetricsRegistry)
from .slo import SLOMonitor
from .tracing import Span, SpanTracer
from .windows import WindowPlane

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "LEVEL_NAMES",
    "AuditRecord", "AuditTrail", "OUTCOME_NAMES",
    "AdaptiveRecord", "AdaptiveTrail",
    "Span", "SpanTracer",
    "WindowPlane", "PredictionScorecard", "SLOMonitor",
    "FlightRecorder",
    "Observability", "record_sim_metrics",
]


@dataclass
class Observability:
    """The per-pipeline observability bundle: one registry, one audit
    ring, one span tracer, sharing lifetime with the pipeline they
    instrument. ``audit=None`` / ``tracer=None`` at construction turn
    those pillars off individually (the registry is always present —
    it is the cheap pillar)."""

    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    audit: AuditTrail | None = None
    tracer: SpanTracer | None = None
    #: adaptive-controller decision ring (`serve.adaptive`); None
    #: turns the reason rows off while the gauges/counters stay on
    adaptive: AdaptiveTrail | None = None
    #: watermark-aligned windowed aggregation (`obs.windows`)
    windows: WindowPlane | None = None
    #: online prediction scorecard + drift (`obs.quality`)
    quality: PredictionScorecard | None = None
    #: declarative SLO burn-rate monitor (`obs.slo`)
    slo: SLOMonitor | None = None
    #: incident flight recorder (`obs.recorder`)
    recorder: FlightRecorder | None = None

    @classmethod
    def full(cls, audit_capacity: int = 4096,
             span_capacity: int = 4096,
             recorder_rows: int = 65536) -> "Observability":
        """Every pillar on — the configuration whose overhead
        `chip_smoke.py`'s `obs_serve` phase measures."""
        reg = MetricsRegistry()
        return cls(registry=reg,
                   audit=AuditTrail(capacity=audit_capacity),
                   tracer=SpanTracer(reg, capacity=span_capacity),
                   adaptive=AdaptiveTrail(),
                   windows=WindowPlane(registry=reg),
                   quality=PredictionScorecard(registry=reg),
                   slo=SLOMonitor(registry=reg),
                   recorder=FlightRecorder(capacity_rows=recorder_rows))

    def span(self, name: str):
        """Span context for `name` (no-op context when tracing off)."""
        if self.tracer is not None:
            return self.tracer.span(name)
        import contextlib
        return contextlib.nullcontext()


def record_sim_metrics(registry: MetricsRegistry, metrics) -> None:
    """Export a `sim.scheduler_sim.SimMetrics` into `registry` under
    the serve-plane schema, so sim runs and live serve runs snapshot
    identically: per-level throttled-seconds become
    ``emergency_throttled_seconds_total{level=...}`` (level order =
    `LEVEL_NAMES` = the emergency plane's apportionment priority
    order), alarms/migrations/placements/failures become counters,
    and the scalar quality ratios become gauges."""
    g = registry.gauge
    c = registry.counter
    c("sim_placements_total",
      help="VM placements committed by the simulator").inc(
          metrics.placements)
    c("sim_failures_total",
      help="VM placements rejected by the simulator").inc(
          metrics.failures)
    g("sim_failure_rate", help="failures / placements").set(
        metrics.failure_rate)
    g("sim_empty_server_ratio",
      help="mean ratio of empty servers over samples").set(
          metrics.empty_server_ratio)
    g("sim_chassis_score_std",
      help="mean std of chassis packing scores").set(
          metrics.chassis_score_std)
    g("sim_server_score_std",
      help="mean std of server packing scores").set(
          metrics.server_score_std)
    for level, secs in zip(LEVEL_NAMES, metrics.throttled_s):
        c("emergency_throttled_seconds_total",
          help="seconds of frequency capping by criticality level",
          level=level).inc(float(secs))
    c("emergency_alarms_total",
      help="power-emergency alarms raised").inc(metrics.alarms)
    c("emergency_migrations_total",
      help="mitigation migrations executed").inc(metrics.migrations)
    g("adaptive_ratio",
      help="oversubscription ratio of the adaptive controller "
      "(1.0 when the controller is off)").set(metrics.adaptive_ratio)
    c("adaptive_ratchet_total",
      help="adaptive-controller up-steps taken").inc(
          metrics.adaptive_ratchets)
    c("adaptive_backoff_total",
      help="adaptive-controller down-steps taken").inc(
          metrics.adaptive_backoffs)
    scored = int(metrics.crit_confusion.sum())
    if scored:
        c("sim_pred_scored_total",
          help="predictions scored against ground truth by the "
          "simulator").inc(scored)
        g("sim_pred_crit_accuracy",
          help="measured criticality-prediction accuracy over the "
          "run (output, not the channel's generative constant)").set(
              metrics.measured_crit_accuracy)
        g("sim_pred_p95_accuracy",
          help="measured P95-bucket-prediction accuracy over the "
          "run").set(metrics.measured_p95_accuracy)
