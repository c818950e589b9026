"""Online prediction-and-admission serving pipeline (paper §II-D), the
torch counterpart of `repro.serve.pipeline.ServePipeline`.

Per micro-batch, with all model operands, subscription aggregates and
cluster aggregates resident on the pipeline's device:

    featurize (serve.featurizer)  ->  four-forest inference + gating
    (serve.inference)  ->  Algorithm-1 placement with power admission
    (serve.placement / serve.admission)

`hot_swap` is the paper's daily retrain: the new forests are packed
into the standby buffer, then one flip routes the next batch to them.

Arrivals, departures and chassis power samples enter through the
per-host ingest (`serve.ingest`): each host owns a stamped queue and a
deterministic watermark merge forms the micro-batches. `submit` is the
1-host case of `submit_to`; `depart_to` and `cap_to` push the other two
event kinds; `flush` serves what is left. `serve` and `depart` bypass
the queue. With `PlaneBundle.emergency` set, power samples step the
power-emergency plane (`serve.emergency`): cap windows queue up and ride
in front of the next micro-batch's placement (`placement.
place_batch_caps`), and the dwell signal feeds `serve.mitigation`. With
`PlaneBundle.ballooning` the windows apply at once, each a balloon step
(`serve.ballooning`) ahead of the emergency step. With
`PlaneBundle.adaptive` every window also steps the adaptive controller
(`serve.adaptive`), whose ratio scales the watt axis of the admission
ceiling before the next micro-batch.

`ShardedServePipeline` partitions the cluster state into shards that
place each micro-batch together under the reserve/commit token protocol
of `serve.sharding`, with `PlaneBundle.cluster_budget` as the token
pool, as a batch axis on one device or one shard a device on a mesh.
`PlaneBundle.obs`, a `repro_torch.obs.Observability`, records what
the pipeline decided (metrics, audit rows, spans, windows, the
prediction scorecard, SLO burn rates, the flight recorder) on the host,
from outputs the device calls already returned: decisions are the same
bits with it on or off.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import features
from repro_torch.core.placement import SchedulerPolicy
from repro_torch.core.predictor import UF, PredictionService
from repro_torch.core.resources import N_RESOURCES, RESOURCES, ResourceVector
from repro_torch.device import resolve_device
from repro_torch.obs import LEVEL_NAMES, Observability
from repro_torch.serve import (adaptive, admission, ballooning, emergency,
                               placement, sharding)
from repro_torch.serve.featurizer import (
    SubscriptionTable, featurize_batch, ingest_population, shard_table,
    table_from_history)
from repro_torch.serve.inference import (
    bucket_to_p95_torch, pack_service, served_query)
from repro_torch.serve.ingest import (
    ARRIVAL, CAPPING, CapBatch, DepartureBatch, IngestMux, MergedEvents,
    slice_soa)
from repro_torch.sim.telemetry import ArrivalBatch, Population


@dataclass(frozen=True)
class PlaneBundle:
    """Control-plane attachments of a pipeline: `chassis_budget`, the
    per-chassis admission budget as a `ResourceVector` (the watts axis
    converts through the power model into the rho ceiling, cores/GB
    axes are ledger currency); `cluster_budget`, the global
    `ResourceVector` whose token pools a `ShardedServePipeline` enforces
    (an unsharded pipeline ignores it); `emergency`, the power-emergency
    plane's `EmergencyConfig`; `ballooning`, the rung between capping
    and migration (it requires `emergency`: it sizes its reclaim with
    the emergency plane's alarm arithmetic); `adaptive`, the closed-loop
    oversubscription controller; and `obs`, the observability plane
    (decision-neutral, host-side)."""
    chassis_budget: ResourceVector | None = None
    cluster_budget: ResourceVector | None = None
    emergency: emergency.EmergencyConfig | None = None
    adaptive: adaptive.AdaptiveConfig | None = None
    ballooning: ballooning.BallooningConfig | None = None
    obs: Observability | None = None


@dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 256
    policy: SchedulerPolicy = field(default_factory=SchedulerPolicy)
    n_ingest_hosts: int = 1         # per-host queues (serve.ingest)
    planes: PlaneBundle = field(default_factory=PlaneBundle)


@dataclass
class ServeResult:
    """Per-arrival decisions for one served batch (host arrays)."""
    server: np.ndarray              # (B,) FAIL_* codes on reject
    workload_type: np.ndarray       # (B,) post-gating UF/NUF
    p95_bucket: np.ndarray          # (B,) post-gating bucket
    p95_eff: np.ndarray             # (B,) p95 recorded into aggregates
    conservative: np.ndarray        # (B,) bool — hit a confidence gate

    @property
    def admitted(self) -> np.ndarray:
        return self.server >= 0

    @property
    def n_admitted(self) -> int:
        return int(self.admitted.sum())

    @property
    def n_capacity_rejected(self) -> int:
        return int((self.server == placement.FAIL_CAPACITY).sum())

    @property
    def n_power_rejected(self) -> int:
        return int((self.server == placement.FAIL_POWER).sum())

    @property
    def n_token_rejected(self) -> int:
        """Arrivals every shard's token pool refused (sharded serving
        under a `cluster_budget`)."""
        return int((self.server == placement.FAIL_TOKENS).sum())

    @property
    def n_conservative(self) -> int:
        return int(self.conservative.sum())


def _concat_results(parts: list) -> ServeResult:
    return ServeResult(*(np.concatenate([getattr(p, f) for p in parts])
                         for f in ("server", "workload_type", "p95_bucket",
                                   "p95_eff", "conservative")))


def _concat_batches(parts: list) -> ArrivalBatch:
    return ArrivalBatch(*(np.concatenate([getattr(p, f) for p in parts])
                          for f in ArrivalBatch.__dataclass_fields__))


def _host(x, dtype=None) -> np.ndarray:
    """A tensor or array as a host numpy array (in `dtype` when given):
    the obs plane's read of an output a device call already returned."""
    a = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return a if dtype is None else a.astype(dtype)


def _unique_chassis_windows(chassis: np.ndarray):
    """Split one merged CAPPING run into maximal prefixes with unique
    chassis ids, in order: a window applies one sample per chassis, so a
    run that samples a chassis twice becomes two windows in turn (the
    hysteresis clocks see both, in merged order)."""
    lo, seen = 0, set()
    for i, c in enumerate(chassis):
        c = int(c)
        if c in seen:
            yield lo, i
            lo, seen = i, set()
        seen.add(c)
    if lo < len(chassis):
        yield lo, len(chassis)


class ServePipeline:
    """Stateful serving endpoint on the device of its state tensors. Not
    thread-safe; one instance serves one cluster."""

    def __init__(self, service: PredictionService,
                 table: SubscriptionTable,
                 state: placement.DeviceClusterState,
                 cores_per_server: int,
                 config: ServeConfig | None = None,
                 blades_per_chassis: int | None = None):
        self.config = config or ServeConfig()
        planes = self.config.planes
        if planes.ballooning is not None and planes.emergency is None:
            raise ValueError(
                "PlaneBundle.ballooning requires PlaneBundle.emergency: the "
                "ballooning rung probes the emergency plane's alarm "
                "arithmetic to size its reclaim")
        self.device = state.free_cores.device
        self.table = table
        self.state = state
        # observability plane (repro_torch.obs): host-side consumers of
        # outputs the device calls already return, so obs on or off never
        # changes a decision
        self.obs = planes.obs
        # ingest watermark (stamp of the newest drained merged run), the
        # clock the windows, SLO and recorder pillars aggregate on; 0.0
        # until the first streamed event
        self._watermark = 0.0
        # direct serve() calls bypass the ingest merge, so their decisions
        # are not replayable: the flight recorder skips them while this
        # flag is up
        self._recorder_suspended = False
        self._batches = 0
        self._has_pool = False      # the sharded subclass may flip it
        self._chassis_of_host = state.chassis_of.cpu().numpy()
        self._rule_idx = self._policy_rule_index(self.config.policy)
        self.cores_per_server = int(cores_per_server)
        # double-buffered model: index _active serves, 1-_active packs
        self._buffers = [pack_service(service, self.device), None]
        self._active = 0
        self.n_chassis = state.rho_max.shape[0]
        if blades_per_chassis is None:
            blades_per_chassis = state.n_servers // self.n_chassis
        self.blades_per_chassis = blades_per_chassis
        # (C, R) per-chassis admission ceilings over the (watts, cores,
        # GB) ledger; an absent budget leaves every column +inf
        self.res_cap = torch.as_tensor(
            admission.resource_caps_from_budget(
                self.config.planes.chassis_budget or ResourceVector(),
                blades_per_chassis, self.n_chassis),
            dtype=state.free_cores.dtype, device=self.device)
        if self.config.n_ingest_hosts < 1:
            raise ValueError(
                f"n_ingest_hosts must be >= 1, "
                f"got {self.config.n_ingest_hosts}")
        self.ingest = IngestMux(self.config.n_ingest_hosts)
        self._pending: list[ArrivalBatch] = []   # merged, awaiting batch
        self._queued = 0
        self.swaps = 0
        self.served = 0
        # power-emergency plane: cap windows queue in merged order and
        # ride in front of the next placement
        self.emergency_cfg = self.config.planes.emergency
        self._pending_caps: list[tuple] = []    # queued (chassis, pw, t)
        self.emergency = None
        self._alarms = 0
        self._cap_epoch = None      # first cap stamp; rebases clocks
        if self.emergency_cfg is not None:
            ecfg = self.emergency_cfg
            if ecfg.blades_per_chassis != self.blades_per_chassis:
                raise ValueError(
                    f"emergency blades_per_chassis="
                    f"{ecfg.blades_per_chassis} does not match the "
                    f"pipeline's {self.blades_per_chassis}: the static "
                    "chassis floor, and every alarm and cut, would be "
                    "miscalibrated")
            self.emergency = self._init_emergency()
        # ballooning rung: fires on the same samples, between the NUF
        # frequency floor and migration
        self._balloon = None
        if planes.ballooning is not None:
            self._balloon = self._init_ballooning()
        # adaptive controller: samples feed per-chassis stability windows,
        # and the stepped ratio rescales the admission ceiling
        self.adaptive_cfg = planes.adaptive
        self._adaptive = None
        self._res_cap_base = self.res_cap
        # (R,) time-of-day multipliers of the cores/GB axes
        # (`set_resource_ratios`); the watts axis stays 1.0
        self._res_ratios = np.ones(N_RESOURCES)
        self._ratio_dev = None      # adaptive ratio, a device scalar
        self._ratio_prev = 1.0      # the ratio before the last scan
        if self.adaptive_cfg is not None:
            acfg = self.adaptive_cfg
            if acfg.blades_per_chassis != self.blades_per_chassis:
                raise ValueError(
                    f"adaptive blades_per_chassis="
                    f"{acfg.blades_per_chassis} does not match the "
                    f"pipeline's {self.blades_per_chassis}: power samples "
                    "would read back as the wrong utilization")
            self._adaptive = self._init_adaptive()

    @property
    def rho_cap(self) -> torch.Tensor:
        """(C,) watt-axis admission ceiling (rho units)."""
        return self.res_cap[..., 0]

    def _init_emergency(self) -> emergency.EmergencyState:
        """Fresh per-chassis emergency state in the state's dtype."""
        return emergency.init_emergency(
            self.n_chassis, dtype=self.state.free_cores.dtype,
            device=self.device)

    def _init_ballooning(self) -> ballooning.BalloonState:
        """Fresh all-deflated balloon state in the state's dtype."""
        return ballooning.init_ballooning(
            self.n_chassis, dtype=self.state.free_cores.dtype,
            device=self.device)

    def _init_adaptive(self) -> adaptive.AdaptiveState:
        """Fresh controller state at ratio 1.0 in the state's dtype."""
        return adaptive.init_adaptive(
            self.adaptive_cfg, self.n_chassis,
            dtype=self.state.free_cores.dtype, device=self.device)

    @property
    def emergency(self):
        """Current emergency-plane state. Reading it applies the cap
        windows still queued, so observers see the state as of the last
        event pushed: the queue saves launches, it never lags."""
        self._flush_caps()
        return self._emergency

    @emergency.setter
    def emergency(self, value):
        self._emergency = value

    @property
    def alarms(self) -> int:
        """Cumulative alarm count over every applied sample window
        (applies queued windows first, like `emergency`)."""
        self._flush_caps()
        return self._alarms

    # -- observability (repro_torch.obs) -------------------------------------
    @staticmethod
    def _policy_rule_index(policy: SchedulerPolicy) -> int:
        """Admission-rule index recorded into the audit trail: 0 =
        packing rule only (NoRule baseline), 1 = power rule only, 2 =
        combined weighted aggregation (the paper's default)."""
        if not policy.use_power_rule or policy.power_weight == 0:
            return 0
        if policy.packing_weight == 0:
            return 1
        return 2

    def _span(self, name: str):
        """Span context for one pipeline stage (no-op without obs)."""
        if self.obs is not None:
            return self.obs.span(name)
        return contextlib.nullcontext()

    def _count_dispatch(self, kind: str) -> None:
        """Count one device step of the pipeline into
        ``serve_dispatch_total{kind=...}`` (the reference's call-site
        names; no-op without obs)."""
        if self.obs is not None:
            self.obs.registry.counter(
                "serve_dispatch_total",
                help="compiled kernel dispatches, by call site",
                kind=kind).inc()

    def _pool_tokens_left(self) -> float:
        """Remaining power tokens recorded into audit rows (+inf when no
        cluster watt budget bounds admission: the unsharded pipeline and
        unbudgeted sharded pipelines)."""
        return float("inf")

    def _record_batch(self, batch: ArrivalBatch, res: ServeResult,
                      raw=None) -> None:
        """Fold one served batch's decisions into the metrics registry,
        the audit trail and the windows, scorecard and flight recorder: a
        host-side reduction of outputs the placement already returned
        (`placement.outcome_counters`, plus the raw heads fetched beside
        them when the quality pillar is on)."""
        if self.obs is None:
            return
        reg = self.obs.registry
        self._batches += 1
        b = len(res.server)
        valid = np.ones(b, bool)
        cnt = placement.outcome_counters(
            res.server, valid, np.asarray(batch.cores), res.p95_eff,
            mem_gb=np.asarray(batch.memory_gb))
        reg.counter("serve_batches_total",
                    help="micro-batches served").inc()
        reg.counter("serve_arrivals_total",
                    help="arrivals decided").inc(b)
        reg.counter("serve_admits_total",
                    help="arrivals admitted").inc(cnt["admits"])
        for reason, key in (("capacity", "fail_capacity"),
                            ("power", "fail_power"),
                            ("tokens", "fail_tokens")):
            reg.counter("serve_rejects_total",
                        help="arrivals rejected, by reason",
                        reason=reason).inc(cnt[key])
        reg.counter("serve_conservative_total",
                    help="decisions that hit a confidence gate").inc(
                        res.n_conservative)
        reg.counter("serve_rho_admitted_total",
                    help="admitted sum(p95*cores), rho units").inc(
                        cnt["rho_admitted"])
        reg.counter("serve_cores_admitted_total",
                    help="admitted virtual cores").inc(
                        cnt["cores_admitted"])
        reg.counter("serve_gb_admitted_total",
                    help="admitted memory, GB").inc(cnt["gb_admitted"])
        if self.obs.audit is not None:
            srv = np.asarray(res.server)
            chassis = np.where(
                srv >= 0, self._chassis_of_host[np.maximum(srv, 0)], -1)
            self.obs.audit.record_batch(
                t=time.time(), batch=self._batches, servers=srv,
                chassis=chassis, rule=self._rule_idx,
                cores=np.asarray(batch.cores),
                is_uf=res.workload_type == UF, p95_eff=res.p95_eff,
                valid=valid, conservative=res.conservative,
                pool_left=self._pool_tokens_left())
        if self.obs.windows is not None:
            w, t = self.obs.windows, self._watermark
            w.observe(t, "arrivals", n=b)
            if cnt["admits"]:
                w.observe(t, "admits", n=int(cnt["admits"]))
            if b - cnt["admits"]:
                w.observe(t, "rejects", n=int(b - cnt["admits"]))
            if res.n_conservative:
                w.observe(t, "conservative", n=int(res.n_conservative))
            w.observe(t, "rho_admitted", float(cnt["rho_admitted"]))
        if self.obs.quality is not None and raw is not None:
            self.obs.quality.record(
                true_crit=np.asarray(batch.user_facing, np.int64),
                true_bucket=np.asarray(
                    features.p95_bucket(np.asarray(batch.p95_util)),
                    np.int64),
                crit_used=res.workload_type,
                bucket_used=res.p95_bucket,
                crit_raw=raw[0], crit_conf=raw[1],
                bucket_raw=raw[2], bucket_conf=raw[3],
                conservative=res.conservative)
        if (self.obs.recorder is not None
                and not self._recorder_suspended):
            self.obs.recorder.record_decision(
                np.asarray(res.server), self._watermark)
        self._obs_tick()

    def _obs_tick(self) -> None:
        """Advance the watermark-clock pillars: close the tumbling
        windows the watermark passed, re-sample the SLO monitor from the
        registry counters, and evaluate the burn-rate alerts (no-op for
        pillars that are off)."""
        if self.obs is None:
            return
        if self.obs.windows is not None:
            self.obs.windows.advance(self._watermark)
        if self.obs.slo is not None:
            self.obs.slo.sample(self._watermark, self.obs.registry)
            self.obs.slo.evaluate(self._watermark)

    def _record_sweep(self, sweep: placement.SweepCounters,
                      windows: int) -> None:
        """Fold one emergency sweep's counters into the registry.
        `windows` is counted on the host (summing per-shard copies would
        overcount it)."""
        if self.obs is None:
            return
        reg = self.obs.registry
        samples = int(_host(sweep.samples))
        alarms = int(_host(sweep.alarms))
        cut_w = float(_host(sweep.cut_w))
        reg.counter("emergency_cap_windows_total",
                    help="cap sample windows applied").inc(windows)
        reg.counter("emergency_samples_total",
                    help="chassis power samples consumed").inc(samples)
        reg.counter("emergency_alarms_total",
                    help="power-emergency alarms raised").inc(alarms)
        reg.counter("emergency_cut_watts_total",
                    help="watts of reduction demanded past the "
                    "target").inc(cut_w)
        reg.counter("emergency_leftover_watts_total",
                    help="demanded watts no frequency floor could "
                    "absorb (RAPL backstop)").inc(
                        float(_host(sweep.leftover_w)))
        if cut_w > 0.0:
            reg.histogram("emergency_cut_watts",
                          help="watts of cut demanded per sweep"
                          ).observe(cut_w)
        for level, w in zip(LEVEL_NAMES,
                            _host(sweep.cut_by_level_w, np.float64)):
            reg.counter("emergency_level_cut_watts_total",
                        help="watts actually removed, by criticality "
                        "level",
                        level=level).inc(float(w))
        if self.obs.windows is not None:
            wp, t = self.obs.windows, self._watermark
            if alarms:
                wp.observe(t, "alarms", n=alarms)
            if cut_w > 0.0:
                wp.observe(t, "cut_watts", cut_w)
                wp.observe_hist("cut_watts", cut_w, lo=0.0, hi=2.0e4)
        if self.obs.quality is not None:
            self.obs.quality.observe_alarms(alarms, cut_w=cut_w,
                                            samples=samples)
        if self.obs.recorder is not None and alarms:
            self.obs.recorder.mark_incident(
                self._watermark, alarms,
                {k: reg.value(k) for k in (
                    "emergency_alarms_total",
                    "emergency_cut_watts_total",
                    "emergency_leftover_watts_total",
                    "serve_arrivals_total")})
        self._obs_tick()

    def _record_adaptive(self, out) -> None:
        """Export one controller decision: ratio gauge, step counters and
        an `obs.audit.AdaptiveTrail` reason row, host-side reads of
        outputs the step already returned."""
        if self.obs is None:
            return
        reg = self.obs.registry
        r = float(out.ratio)
        ratchet, backoff = bool(out.ratchet), bool(out.backoff)
        reg.gauge("adaptive_ratio",
                  help="oversubscription ratio of the adaptive "
                  "controller").set(r)
        reg.counter("adaptive_ratchet_total",
                    help="adaptive-controller up-steps taken").inc(
                        int(ratchet))
        reg.counter("adaptive_backoff_total",
                    help="adaptive-controller down-steps taken").inc(
                        int(backoff))
        if self.obs.adaptive is not None:
            n_known = int(out.n_known)
            self.obs.adaptive.record(
                t=time.time(), shard=-1, ratio=r,
                stable_frac=float(out.stable_frac), n_known=n_known,
                n_stable=int(out.n_stable),
                action=1 if ratchet else (-1 if backoff else 0),
                reason=adaptive.decision_reason(
                    self._ratio_prev, r, n_known, ratchet, backoff,
                    bool(out.hot)))
        self._ratio_prev = r

    @classmethod
    def from_history(cls, service: PredictionService, history: Population,
                     uf_labels, n_servers: int, cores_per_server: int,
                     blades_per_chassis: int,
                     table_capacity: int | None = None,
                     config: ServeConfig | None = None,
                     device=None, **kw) -> "ServePipeline":
        """Bootstrap table + empty cluster on `device` (the card unless
        ``device="cpu"``) from an offline labeled history; `kw` go to the
        constructor (`ShardedServePipeline`'s `mesh`)."""
        dev = resolve_device(device)
        if table_capacity is None:
            table_capacity = max(
                (v.subscription for v in history.vms), default=0) + 1024
        labels = uf_labels.cpu().numpy() if torch.is_tensor(uf_labels) \
            else uf_labels
        table = table_from_history(history, labels, table_capacity, dev)
        state = placement.fresh_state(
            n_servers, cores_per_server,
            np.arange(n_servers) // blades_per_chassis, device=dev)
        return cls(service, table, state, cores_per_server, config=config,
                   blades_per_chassis=blades_per_chassis, **kw)

    def hot_swap(self, new_service: PredictionService) -> None:
        """Pack the retrained forests into the standby buffer, then flip.
        Calls between pack and flip keep using the old model."""
        standby = 1 - self._active
        self._buffers[standby] = pack_service(new_service, self.device)
        self._active = standby
        self.swaps += 1
        if self.obs is not None and self.obs.quality is not None:
            # the old model's confusion, calibration and drift say nothing
            # about the one now serving
            self.obs.quality.on_hot_swap()

    def observe(self, history: Population, uf_labels) -> None:
        """Fold freshly labeled telemetry into the subscription
        aggregates."""
        self.table = ingest_population(self.table, history, uf_labels)

    def submit(self, batch: ArrivalBatch) -> list[ServeResult]:
        """Ingest arrivals through the single queue and serve every full
        micro-batch; returns the results that became ready (call `flush`
        for a partial tail). The 1-host case of `submit_to`: a pipeline
        with ``n_ingest_hosts > 1`` must say which host queue an arrival
        belongs to."""
        if self.config.n_ingest_hosts != 1:
            raise ValueError(
                "submit() is the single-queue (1-host) path; with "
                f"n_ingest_hosts={self.config.n_ingest_hosts} use "
                "submit_to(host, batch, t=...)")
        return self.submit_to(0, batch)

    def submit_to(self, host: int, batch: ArrivalBatch,
                  t=None) -> list[ServeResult]:
        """Push a stamped arrival chunk into `host`'s ingest queue and
        serve whatever the fleet watermark releases. `t`: per-arrival
        non-decreasing stamps ((B,) array; None = the host-local unit
        clock). Micro-batches form over the merged stream, so with
        several hosts a batch is served only once every host's clock has
        passed it: push (or `flush`) from all hosts to keep the
        watermark moving."""
        with self._span("ingest"):
            self.ingest.submit_to(host, batch, t)
        with self._span("merge"):
            events = self.ingest.poll()
        return self._drain_events(events)

    def depart_to(self, host: int, servers, cores, p95_eff, is_uf,
                  t=None, mem_gb=None) -> list[ServeResult]:
        """Push a stamped departure batch into `host`'s ingest queue. It
        takes effect at its merged-stream position, at micro-batch
        granularity: before any micro-batch served after it, so every
        arrival merged later sees the freed capacity, and so do arrivals
        merged earlier that still wait in the unfilled micro-batch.
        Rows with negated cores are pinned arrivals (`serve.mitigation`).
        Advancing this host's clock can release queued micro-batches;
        their results are returned."""
        with self._span("ingest"):
            self.ingest.depart_to(host, DepartureBatch(
                np.asarray(servers, np.int32),
                np.asarray(cores, np.float32),
                np.asarray(p95_eff, np.float32), np.asarray(is_uf, bool),
                None if mem_gb is None
                else np.asarray(mem_gb, np.float32)), t)
        with self._span("merge"):
            events = self.ingest.poll()
        return self._drain_events(events)

    def cap_to(self, host: int, chassis, power_w,
               t=None) -> list[ServeResult]:
        """Push a stamped batch of chassis power samples into `host`'s
        ingest queue: the cap and uncap events of the power-emergency
        plane. They apply at their merged-stream position, so alarms,
        lifts and the effects of any mitigation traffic do not depend on
        the host count. Needs a pipeline built with
        `PlaneBundle.emergency` or `PlaneBundle.adaptive` (either plane
        reads the samples). Advancing this host's clock can release
        queued micro-batches; their results are returned."""
        if self.emergency_cfg is None and self.adaptive_cfg is None:
            raise ValueError(
                "cap_to() needs a pipeline built with "
                "PlaneBundle.emergency or PlaneBundle.adaptive")
        with self._span("ingest"):
            self.ingest.cap_to(host, CapBatch(
                np.asarray(chassis, np.int32),
                np.asarray(power_w, np.float32)), t)
        with self._span("merge"):
            events = self.ingest.poll()
        return self._drain_events(events)

    def flush(self) -> ServeResult | None:
        """Serve everything still queued, watermark ignored (padded up to
        the batch size; chunked if the drain releases more than one
        micro-batch), and apply trailing cap windows. Returns one
        concatenated result, or None."""
        with self._span("merge"):
            events = self.ingest.drain()
        out = self._drain_events(events)
        if self._queued:
            merged = _concat_batches(self._pending)
            self._pending, self._queued = [], 0
            out.append(self._serve_padded(merged))
        self._flush_caps()          # trailing caps with no batch to ride
        if not out:
            return None
        return out[0] if len(out) == 1 else _concat_results(out)

    def _drain_events(self, events: MergedEvents) -> list[ServeResult]:
        """Apply one released merged-event window in stream order:
        arrival runs accumulate toward (and serve) full micro-batches,
        departure and cap runs apply at their merged position (before
        any micro-batch served after them). The flight recorder, when
        on, copies every run as it applies."""
        bs = self.config.batch_size
        out: list[ServeResult] = []
        rec = None if self.obs is None else self.obs.recorder
        pos = 0
        for kind, lo, hi in events.runs():
            t_run = events.t[pos:pos + (hi - lo)]
            pos += hi - lo
            if len(t_run):
                # the merged stream is the clock the windows, SLO and
                # recorder pillars aggregate on
                self._watermark = float(t_run[-1])
            if kind == CAPPING:
                caps = slice_soa(events.caps, lo, hi)
                if rec is not None:
                    rec.record_caps(t_run, caps)
                self._apply_caps(caps, t_run)
                continue
            if kind != ARRIVAL:
                d = slice_soa(events.departures, lo, hi)
                if rec is not None:
                    rec.record_departures(t_run, d)
                self._apply_departures(d.server, d.cores, d.p95_eff,
                                       d.is_uf, d.mem_gb)
                continue
            arr = slice_soa(events.arrivals, lo, hi)
            if rec is not None:
                rec.record_arrivals(t_run, arr)
            self._pending.append(arr)
            self._queued += hi - lo
            if self._queued < bs:
                continue
            merged = _concat_batches(self._pending)  # one copy, slice
            start = 0
            while self._queued - start >= bs:
                out.append(self._serve_padded(
                    slice_soa(merged, start, start + bs)))
                start += bs
            self._pending = [slice_soa(merged, start, len(merged))]
            self._queued -= start
        return out

    def serve(self, batch: ArrivalBatch) -> ServeResult:
        """Serve one batch synchronously, bypassing the queue, in
        micro-batches of the configured size. Bypassed batches are
        invisible to the flight recorder: only the streamed (queue) path
        is replayable (`obs.recorder`)."""
        self._recorder_suspended = True
        try:
            bs = self.config.batch_size
            if len(batch) <= bs:
                return self._serve_padded(batch)
            parts = [ArrivalBatch(*(getattr(batch, f)[i:i + bs]
                                    for f in
                                    ArrivalBatch.__dataclass_fields__))
                     for i in range(0, len(batch), bs)]
            return _concat_results([self._serve_padded(p) for p in parts])
        finally:
            self._recorder_suspended = False

    def _serve_padded(self, batch: ArrivalBatch) -> ServeResult:
        b = len(batch)
        pad_to = self.config.batch_size
        packed, meta = self._buffers[self._active]
        with self._span("featurize"):
            x = featurize_batch(self.table, batch, pad_to=pad_to,
                                device=self.device)
        with self._span("infer"):
            q = served_query(packed, meta, x)
            is_uf = q["workload_type_used"] == UF
            if self.config.policy.use_utilization_predictions:
                p95_eff = bucket_to_p95_torch(q["p95_bucket_used"])
            else:
                p95_eff = torch.ones(pad_to, dtype=torch.float32,
                                     device=self.device)

        def padded(a):
            out = np.zeros(pad_to, np.float32)
            out[:b] = a
            return torch.as_tensor(out, device=self.device)
        valid = torch.arange(pad_to, device=self.device) < b
        cores, mem = padded(batch.cores), padded(batch.memory_gb)
        with self._span("place"):
            servers = self._place(cores, is_uf, p95_eff, valid, mem, b)
        self.served += b
        with self._span("commit"):
            # the quality pillar also reads the raw (ungated) heads and
            # their confidences, from the same forest launch: more copies
            # to the host, no input to any device call
            fetch = (servers, q["workload_type_used"], q["p95_bucket_used"],
                     p95_eff, q["conservative"])
            score = self.obs is not None and self.obs.quality is not None
            if score:
                fetch += (q["workload_type"], q["workload_conf"],
                          q["p95_bucket"], q["p95_conf"])
            host = [a[:b].cpu().numpy() for a in fetch]
        res = ServeResult(*host[:5])
        self._record_batch(batch, res, raw=host[5:] if score else None)
        return res

    def _place(self, cores, is_uf, p95_eff, valid, mem, n_valid: int):
        """Placement stage of one padded micro-batch (its first `n_valid`
        rows real): Algorithm 1 with power admission against the cluster
        state; returns the (B,) decisions (FAIL_* codes on reject). Cap
        windows queued since the last batch are applied first
        (`placement.place_batch_caps`)."""
        if self._pending_caps:
            n_windows = len(self._pending_caps)
            pw, mask, ts = self._stacked_caps()
            self._pending_caps = []
            self._count_dispatch("place_batch_caps")
            (self.state, servers, self._emergency,
             sweep) = placement.place_batch_caps(
                self.state, self._emergency, pw, mask, ts, cores, is_uf,
                p95_eff, valid, self.res_cap, self.config.policy,
                self.cores_per_server, self.emergency_cfg, mem_gb=mem)
            self._alarms += int(sweep.alarms)
            self._record_sweep(sweep, windows=n_windows)
            return servers
        self._count_dispatch("place_batch")
        self.state, servers = placement.place_batch(
            self.state, cores, is_uf, p95_eff, valid, self.res_cap,
            self.config.policy, self.cores_per_server, mem_gb=mem)
        return servers

    def _stacked_caps(self):
        """The queued unique-chassis windows as stacked (W, C)
        `emergency.masked_step` operands on the device, merged order
        kept."""
        rows = [emergency.scatter_samples_np(self.n_chassis, c, p, t,
                                             np.float64)
                for c, p, t in self._pending_caps]
        dtype = self.state.free_cores.dtype

        def stack(k, dt=dtype):
            return torch.as_tensor(np.stack([r[k] for r in rows]),
                                   device=self.device).to(dt)
        return stack(0), stack(1, torch.bool), stack(2)

    def depart(self, servers, cores, p95_eff, is_uf, mem_gb=None) -> None:
        """Release departed VMs' aggregates now (batched, order-free):
        the 1-host case. `depart_to` is the stream-ordered per-host path;
        like `submit`, this refuses multi-host pipelines, since applying
        a departure outside the merged order would break the order the
        merge promises."""
        if self.config.n_ingest_hosts != 1:
            raise ValueError(
                "depart() is the single-queue (1-host) path; with "
                f"n_ingest_hosts={self.config.n_ingest_hosts} use "
                "depart_to(host, ..., t=...)")
        self._apply_departures(servers, cores, p95_eff, is_uf, mem_gb)

    def _apply_departures(self, servers, cores, p95_eff, is_uf,
                          mem_gb=None) -> None:
        """Apply a departure batch to the cluster state. Queued cap
        windows apply first: they were merged earlier and must read the
        aggregates before the departure."""
        self._flush_caps()
        self.state = placement.remove_batch(self.state, servers, cores,
                                            p95_eff, is_uf, mem_gb=mem_gb)

    # -- power-emergency plane (serve.emergency) ---------------------------
    def _apply_caps(self, batch: CapBatch, t: np.ndarray) -> None:
        """Consume one merged CAPPING run: split it into unique-chassis
        windows and queue them in merged order for the next placement
        (`_place`). A cap touches only the emergency state, and every
        change of the aggregates it reads applies the queue first
        (departures) or applies it ahead of the change (arrival batches),
        so a queued window sees the aggregates it would have seen at its
        merged position. Stamps are rebased to the first cap stamp the
        pipeline saw: float32 clocks would quantize the 30 s lift and
        dwell windows away at epoch-second stamps (~1e9).

        The adaptive controller steps on each window at once: it reads
        only the placement aggregates, and its ratio must bind the very
        next micro-batch. With the ballooning rung the emergency windows
        apply at once too: a balloon deferred to ride with a batch would
        read the memory ledger after that batch changed it."""
        if self.emergency_cfg is None and self.adaptive_cfg is None:
            raise ValueError(
                "received CAPPING events but the pipeline was built "
                "without PlaneBundle.emergency or PlaneBundle.adaptive")
        if self._cap_epoch is None:
            self._cap_epoch = float(t[0])
        t = np.asarray(t, np.float64) - self._cap_epoch
        for lo, hi in _unique_chassis_windows(batch.chassis):
            if self.adaptive_cfg is not None:
                self._adaptive_scan(batch.chassis[lo:hi],
                                    batch.power_w[lo:hi])
            if self.emergency_cfg is not None:
                self._pending_caps.append(
                    (batch.chassis[lo:hi], batch.power_w[lo:hi], t[lo:hi]))
        if self._balloon is not None:
            self._flush_caps()

    def _flush_caps(self) -> None:
        """Apply the queued cap windows one at a time: the path for
        windows no placement batch will carry (reads of `emergency` or
        `alarms`, departures, the end of a `flush`)."""
        pending, self._pending_caps = self._pending_caps, []
        for chassis, power_w, t in pending:
            with self._span("emergency"):
                out = self._cap_window(chassis, power_w, t)
            alarms = int(out.alarm.sum())
            self._alarms += alarms
            if self.obs is not None:
                cbl = _host(out.cut_by_level_w, np.float64)
                self._record_sweep(placement.SweepCounters(
                    samples=len(chassis), alarms=alarms,
                    cut_w=_host(out.cut_w, np.float64).sum(),
                    leftover_w=_host(out.leftover_w, np.float64).sum(),
                    cut_by_level_w=cbl.reshape(
                        -1, emergency.N_LEVELS).sum(0)), windows=1)

    def _cap_window(self, chassis, power_w, t):
        """Apply one unique-chassis sample window, through the balloon
        step first when the rung is attached; returns the emergency
        step's `EmergencyOutputs`."""
        pw, mask, ts = emergency.scatter_samples(
            self.n_chassis, chassis, power_w, t,
            self.state.free_cores.dtype, self.device)
        rho_lv = emergency.chassis_rho_levels(
            self.state.gamma_nuf, self.state.gamma_uf,
            self.state.chassis_servers)
        if self._balloon is not None:
            self._count_dispatch("balloon_cap_step")
            self._balloon, bout = ballooning.balloon_step(
                self.config.planes.ballooning, self.emergency_cfg,
                self._balloon, rho_lv, pw, self.state.mem_nuf, mask)
            pw = bout.power_adj_w
        else:
            self._count_dispatch("cap_step")
        self._emergency, out = emergency.masked_step(
            self.emergency_cfg, self._emergency, rho_lv, pw, mask, ts)
        if self._balloon is not None:
            self._record_balloon(bout)
        return out

    # -- ballooning rung (serve.ballooning) ----------------------------------
    @property
    def balloon_state(self):
        """Current `serve.ballooning.BalloonState` (None with the rung
        off); reading it applies queued cap windows like `emergency`."""
        self._flush_caps()
        return self._balloon

    def ballooned_gb(self) -> float:
        """Fleet-wide GB currently ballooned out (0.0 with the rung
        off)."""
        if self._balloon is None:
            return 0.0
        self._flush_caps()
        return self._total_ballooned_gb()

    def _total_ballooned_gb(self) -> float:
        return ballooning.total_ballooned_gb(self._balloon)

    def _record_balloon(self, bout) -> None:
        """Export one balloon sweep's outputs: reclaim/release/absorb
        counters and the standing-balloon gauge, host-side reductions of
        outputs the step already returned."""
        if self.obs is None:
            return
        reg = self.obs.registry
        reg.counter("balloon_reclaimed_gb_total",
                    help="GB ballooned out of NUF VMs").inc(
                        float(_host(bout.reclaimed_gb, np.float64).sum()))
        reg.counter("balloon_released_gb_total",
                    help="ballooned GB handed back on alarm clear").inc(
                        float(_host(bout.released_gb, np.float64).sum()))
        reg.counter("balloon_absorbed_watts_total",
                    help="DRAM watts absorbed by standing + fresh "
                    "balloons").inc(
                        float(_host(bout.absorbed_w, np.float64).sum()))
        reg.counter("balloon_inflations_total",
                    help="chassis sweeps where the rung fired").inc(
                        int(_host(bout.inflated).sum()))
        reg.gauge("balloon_ballooned_gb",
                  help="fleet GB currently ballooned out").set(
                      self._total_ballooned_gb())

    # -- adaptive oversubscription (serve.adaptive) --------------------------
    @property
    def adaptive_state(self):
        """Current `serve.adaptive.AdaptiveState` (None with the
        controller off). It steps when a window is consumed, so its ratio
        already binds the next micro-batch."""
        return self._adaptive

    @property
    def adaptive_ratio(self) -> float:
        """Current oversubscription ratio (1.0 with the controller off)."""
        if self._adaptive is None:
            return 1.0
        return float(self._adaptive.ratio)

    def _adaptive_scan(self, chassis, power_w) -> None:
        """One controller scan over a unique-chassis sample window, then
        the stepped ratio put in force."""
        pw, mask, _ = emergency.scatter_samples(
            self.n_chassis, chassis, power_w, np.zeros(len(chassis)),
            self.state.free_cores.dtype, self.device)
        rho_lv = emergency.chassis_rho_levels(
            self.state.gamma_nuf, self.state.gamma_uf,
            self.state.chassis_servers)
        self._count_dispatch("adaptive_step")
        self._adaptive, out = adaptive.adaptive_step(
            self.adaptive_cfg, self._adaptive, rho_lv, pw, mask)
        self._apply_ratio(out)

    def _apply_ratio(self, out) -> None:
        """Scale the watt axis of the admission ceiling by the stepped
        ratio, on the device (no host sync with obs off). With
        ``AdaptiveConfig.hold_on_stale`` the *applied* ratio is clamped
        to ``ratio_min`` while the obs plane's prediction scorecard
        reports `model_stale` (`adaptive.gate_ratio_on_stale`); the
        controller state is untouched, so the ratio resumes once the
        model scores fresh. Without the scorecard it has no effect."""
        self._ratio_dev = out.ratio
        cfg = self.adaptive_cfg
        if (cfg.hold_on_stale and self.obs is not None
                and self.obs.quality is not None):
            self._ratio_dev = adaptive.gate_ratio_on_stale(
                cfg, out.ratio, self.obs.quality.model_stale)
        self._refresh_caps()
        self._record_adaptive(out)

    def _axis_mult(self, dtype) -> torch.Tensor:
        """(R,) ceiling multiplier: the adaptive ratio on the watts axis
        times the time-of-day ratios on the cores/GB axes. Both default to
        1.0, and a multiply by 1.0 is the identity, so with neither plane
        the base ceiling passes through bit for bit."""
        one = torch.ones((), dtype=dtype, device=self.device)
        r = one if self._ratio_dev is None else self._ratio_dev.to(dtype)
        return torch.stack([r, one, one]) * torch.as_tensor(
            self._res_ratios, dtype=dtype, device=self.device)

    def _refresh_caps(self) -> None:
        """Recompute the admission ceiling from the base ceiling and the
        current per-axis multipliers."""
        self.res_cap = self._res_cap_base \
            * self._axis_mult(self._res_cap_base.dtype)

    def set_resource_ratios(self, ratios) -> None:
        """Install a fresh (R,) time-of-day sample
        (`core.resources.trough_ratios`): the cores/GB axes of the
        ceiling rescale at once. The watts axis must be exactly 1.0: a
        breaker budget is a physical limit and never ratchets."""
        ratios = np.asarray(ratios, np.float64)
        if ratios.shape != (N_RESOURCES,):
            raise ValueError(
                f"ratios must be ({N_RESOURCES},) over {RESOURCES}, "
                f"got shape {ratios.shape}")
        if ratios[0] != 1.0:
            raise ValueError(
                f"ratios[0] (watts) must be 1.0, got {ratios[0]}: the watt "
                "budget is a breaker limit and never ratchets")
        self._res_ratios = ratios
        self._refresh_caps()

    def throttled_by_level(self) -> np.ndarray:
        """(L,) cumulative throttled-seconds per criticality level (index
        `emergency.CRIT_UF` = critical); zeros without the plane."""
        if self.emergency is None:
            return np.zeros(emergency.N_LEVELS)
        return emergency.throttled_by_level(self.emergency)

    def mitigation_due_chassis(self) -> np.ndarray:
        """Ids of chassis whose cap has dwelled past
        `EmergencyConfig.dwell_s` with the critical level throttled: feed
        them, with a VM registry, to `serve.mitigation.plan_migrations`
        and push the plan's paired events through `depart_to`."""
        if self.emergency is None:
            return np.empty(0, np.int64)
        due = emergency.mitigation_due(self.emergency_cfg, self.emergency)
        return np.flatnonzero(due.cpu().numpy().reshape(-1))

    def reset_dwell(self, chassis) -> None:
        """Zero the dwell clock of the given chassis ids (call after
        emitting a migration plan for them)."""
        mask = np.zeros(self.n_chassis, bool)
        mask[np.asarray(chassis, np.int64)] = True
        self.emergency = emergency.reset_dwell(
            self.emergency, torch.as_tensor(self._dwell_mask(mask),
                                            device=self.device))

    def _dwell_mask(self, mask: np.ndarray) -> np.ndarray:
        """A (C,) chassis mask in the emergency state's chassis layout
        (the identity for one unsharded state)."""
        return mask

    def chassis_headroom_w(self, budget_w) -> np.ndarray:
        """(C,) watts of remaining per-chassis admission headroom."""
        return admission.headroom_w(self.state, budget_w,
                                    self.blades_per_chassis)


@dataclass(frozen=True)
class ShardedServeConfig(ServeConfig):
    """`ServeConfig` plus the sharded-placement knobs, the reference's.
    `batch_size` must be divisible by `n_shards`. `use_shard_map`: True
    puts one shard on each of the first N cards (and raises with fewer),
    False (the default) runs the shards as a batch axis on the pipeline's
    device, "auto" takes the cards when a pipeline on the card finds N of
    them, else the batch axis. The reference defaults to "auto"; here the
    batch axis is the default because the mesh leg makes about N times
    its launches from one host thread, which distinct cards do not
    remove. `spill_rounds`: spillover rounds after the home
    round (None: N-1). `rebalance_tokens`: equalize the pools before each
    spillover round. `shard_table`: on a mesh, row-partition the
    subscription table over it (`featurizer.shard_table`)."""
    n_shards: int = 1
    use_shard_map: bool | str = False       # True | False | "auto"
    spill_rounds: int | None = None         # None: n_shards - 1
    rebalance_tokens: bool = True
    shard_table: bool = True

    def __post_init__(self):
        if self.use_shard_map not in (True, False, "auto"):
            raise ValueError(f"use_shard_map must be True, False or 'auto', "
                             f"got {self.use_shard_map!r}")
        if self.spill_rounds is not None and self.spill_rounds < 0:
            raise ValueError(f"spill_rounds must be >= 0 or None, got "
                             f"{self.spill_rounds}")


def _mesh_for(config: ShardedServeConfig, device: torch.device, mesh):
    """The pipeline's mesh: `mesh` when given (N devices), whatever
    `use_shard_map` says, else as `use_shard_map` says (None: the batch
    axis)."""
    n = config.n_shards
    if mesh is not None:
        return sharding.shard_mesh(n, devices=mesh)
    if config.use_shard_map == "auto":
        return sharding.shard_mesh(n) if n > 1 and device.type == "cuda" \
            else None
    if config.use_shard_map:
        mesh = sharding.shard_mesh(n)
        if mesh is None:
            have = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            raise RuntimeError(f"use_shard_map=True needs >= {n} cards, "
                               f"have {have}")
    return mesh


class ShardedServePipeline(ServePipeline):
    """`ServePipeline` with the cluster state partitioned into shards
    (`serve.sharding`). Featurization and forest inference are
    shard-agnostic (one call a micro-batch); the placement fans out:
    arrivals go to their home shard, place together under the
    reserve/commit token protocol, and spill to the other shards when the
    home shard rejects them. `PlaneBundle.cluster_budget` sets the global
    budget the pools enforce: the admitted ``p95*cores`` over all shards
    never exceeds its rho-unit pool while the pools are only drawn and
    credited. Retargeting them (an adaptive scan, `set_resource_ratios`)
    floors each shard's pool at 0 on its own, as the reference does, so
    once a shard has committed past its 1/N slice of the budget the other
    shards are handed more than the budget has left (ROADMAP.md Queue 3).
    The emergency, ballooning and adaptive planes run per shard, each
    shard over the chassis it owns.

    `mesh` (a `sharding.shard_mesh`, N devices, one may repeat) puts one
    shard on each of its devices; without it `config.use_shard_map`
    decides (`ShardedServeConfig`; by default the batch axis). On a mesh
    `sharded` and the plane states are `sharding.OnMesh` groups, each on
    its device, and the subscription table is row-partitioned over it
    with `config.shard_table`; featurization and inference stay on the
    pipeline's device. `emergency`, `balloon_state` and `adaptive_state`
    read the plane states stacked on the pipeline's device, whichever
    leg runs. `self.mesh` is the mesh, or None for the batch axis.

    `state` and `res_cap` read the shards (`global_state()` and the
    per-shard ceilings in force, in global chassis order) and cannot be
    assigned: the shards live in `sharded`."""

    def __init__(self, service: PredictionService,
                 table: SubscriptionTable,
                 state: placement.DeviceClusterState,
                 cores_per_server: int,
                 config: ShardedServeConfig | None = None,
                 blades_per_chassis: int | None = None, mesh=None):
        config = config or ShardedServeConfig()
        if config.batch_size % config.n_shards:
            raise ValueError(
                f"batch_size {config.batch_size} not divisible by "
                f"n_shards {config.n_shards}")
        # the plane states go onto the mesh as the base constructor makes
        # them
        self.mesh = _mesh_for(config, state.free_cores.device, mesh)
        super().__init__(service, table, state, cores_per_server,
                         config=config,
                         blades_per_chassis=blades_per_chassis)
        n = config.n_shards
        budget = config.planes.cluster_budget
        # gross: the ratio-1.0 (R,) allowance the adaptive controller
        # retargets the free pools against
        gross = np.full(N_RESOURCES, np.inf) if budget is None else \
            sharding.resource_pool_from_budget(budget, state.n_servers)
        finite = np.isfinite(gross)
        pool_total = None
        if finite.any():
            # a warm cluster has resources committed already: the pool is
            # what remains of the allowance on each axis, so the budget
            # holds from the first batch
            committed = state.res_peak.cpu().numpy().astype(
                np.float64).sum(0)
            pool_total = np.where(finite, np.maximum(gross - committed, 0.0),
                                  np.inf)
        self._has_pool = pool_total is not None
        sharded = sharding.shard_state(
            self.state, n, rho_cap=self.res_cap, pool_total=pool_total)
        del self._handed_over       # the shards hold the state and caps
        # the (N, C/N, R) ceilings at ratio 1.0, on the pipeline's device
        self._sharded_cap_base = sharded.res_cap
        if self.mesh is not None:
            sharded = sharding.device_put_sharded_state(sharded, self.mesh)
            if config.shard_table:
                self.table = shard_table(self.table, self.mesh)
        self.sharded = sharded
        self._pool_base = None if pool_total is None else torch.as_tensor(
            np.broadcast_to(gross / n, (n, N_RESOURCES)).copy()).to(
                device=self.device, dtype=state.free_cores.dtype)
        self._ratio_prev = np.ones(n)
        self.spill_info = {"rounds": 0, "spilled": 0, "spill_admitted": 0}

    # `state` and `res_cap` as the base constructor assigns them, then as
    # views of the shards
    def _view(name):
        def get(self):
            if "sharded" not in self.__dict__:
                return self._handed_over[name]
            if name == "state":
                return self.global_state()
            caps = [g.res_cap.to(self.device)
                    for g in sharding.groups_of(self.sharded)]
            cap = caps[0] if len(caps) == 1 else torch.cat(caps)
            return cap.reshape(-1, N_RESOURCES)

        def put(self, value):
            if "sharded" in self.__dict__:
                raise AttributeError(
                    f"ShardedServePipeline.{name} is a view of the shards: "
                    "they live in `sharded`")
            self.__dict__.setdefault("_handed_over", {})[name] = value
        return property(get, put)

    state = _view("state")
    res_cap = _view("res_cap")
    del _view

    # -- placement -----------------------------------------------------------
    def _place(self, cores, is_uf, p95_eff, valid, mem, n_valid: int):
        """The sharded protocol on one padded micro-batch; the cap windows
        queued since the last batch step in its home round."""
        cfg = self.config
        kw = {}
        fused = bool(self._pending_caps)
        if fused:
            n_windows = len(self._pending_caps)
            kw = dict(emer=self._emergency, caps=self._sharded_caps(),
                      ecfg=self.emergency_cfg)
            self._pending_caps = []
        if self.obs is not None:
            kw["registry"] = self.obs.registry
        out = sharding.place_group_sharded(
            self.sharded, cores, is_uf, p95_eff,
            np.arange(len(cores)) < n_valid, cfg.policy,
            self.cores_per_server, mem_gb=mem, spill_rounds=cfg.spill_rounds,
            rebalance=cfg.rebalance_tokens, **kw)
        if fused:
            self.sharded, servers, info, self._emergency, sweep = out
            self._alarms += int(sweep.alarms)
            self._record_sweep(sweep, windows=n_windows)
        else:
            self.sharded, servers, info = out
        self.spill_info = {k: v + info[k] for k, v in self.spill_info.items()}
        self._record_spill(info)
        return torch.as_tensor(servers)

    def _record_spill(self, info: dict) -> None:
        """Fold one sharded placement's spillover and token counters into
        the registry (host-side, from the returned ``info``; the pool
        gauges read the pools back)."""
        if self.obs is None:
            return
        reg = self.obs.registry
        reg.counter("serve_spill_rounds_total",
                    help="spillover rounds run beyond the home round"
                    ).inc(max(info["rounds"] - 1, 0))
        reg.counter("serve_spilled_total",
                    help="arrivals that entered a spillover round").inc(
                        info["spilled"])
        reg.counter("serve_spill_admits_total",
                    help="arrivals admitted by a spillover round").inc(
                        info["spill_admitted"])
        if not self._has_pool:
            return
        reg.counter("serve_tokens_drawn_total",
                    help="power tokens drawn from the pools, "
                    "rho units").inc(max(0.0, info.get("tokens_drawn", 0.0)))
        drawn = np.asarray(info.get(
            "tokens_drawn_vec", np.zeros(N_RESOURCES)), np.float64)
        pools = sharding.pool_left(self.sharded)
        for r, name in enumerate(RESOURCES):
            reg.counter("serve_tokens_drawn_res_total",
                        help="tokens drawn from the pools, by "
                        "resource axis",
                        resource=name).inc(max(0.0, float(drawn[r])))
        for i, row in enumerate(pools):
            reg.gauge("serve_pool_tokens",
                      help="remaining power tokens, by shard",
                      shard=str(i)).set(float(row[0]))
            for r, name in enumerate(RESOURCES):
                if np.isfinite(row[r]):
                    reg.gauge("serve_pool_resources",
                              help="remaining tokens, by shard "
                              "and resource axis",
                              shard=str(i),
                              resource=name).set(float(row[r]))

    def _pool_tokens_left(self) -> float:
        if not self._has_pool:
            return float("inf")
        return float(sharding.pool_left(self.sharded)[:, 0].sum())

    def _sharded_caps(self):
        """The queued unique-chassis windows as stacked (N, W, C/N)
        operands of the home round, merged order kept (host numpy)."""
        rows = [sharding.split_caps(self.sharded, c, p, t)
                for c, p, t in self._pending_caps]
        return tuple(np.stack([r[k] for r in rows], axis=1)
                     for k in range(3))

    def _apply_departures(self, servers, cores, p95_eff, is_uf,
                          mem_gb=None) -> None:
        """Each departure leaves its owner shard and credits its (R,)
        demand to that shard's pool (`sharding.remove_sharded`). Queued
        cap windows apply first: they read the aggregates before it. The
        obs plane counts the rho credited back
        (``serve_tokens_credited_total``)."""
        self._flush_caps()
        if self.obs is not None and self._has_pool:
            srv = np.asarray(servers)
            live = srv >= 0
            credit = (np.asarray(p95_eff, np.float64)[live]
                      * np.asarray(cores, np.float64)[live]).sum()
            self.obs.registry.counter(
                "serve_tokens_credited_total",
                help="power tokens credited back by departures, "
                "rho units").inc(float(credit))
        self.sharded = sharding.remove_sharded(
            self.sharded, servers, cores, p95_eff, is_uf, mem_gb=mem_gb)

    # -- the planes, per shard -----------------------------------------------
    def _on_mesh(self, value):
        """A stacked plane state on the pipeline's mesh (as it is without
        one)."""
        return value if self.mesh is None \
            else sharding.device_put_sharded_state(value, self.mesh)

    def _stacked(self, value):
        """A plane state stacked on the pipeline's device."""
        return sharding.from_mesh(value, self.device)

    def _init_emergency(self):
        return self._on_mesh(sharding.init_emergency_sharded(
            self.n_chassis, self.config.n_shards,
            dtype=self.state.free_cores.dtype, device=self.device))

    def _init_ballooning(self):
        return self._on_mesh(sharding.init_ballooning_sharded(
            self.n_chassis, self.config.n_shards,
            dtype=self.state.free_cores.dtype, device=self.device))

    def _init_adaptive(self):
        return self._on_mesh(sharding.init_adaptive_sharded(
            self.adaptive_cfg, self.n_chassis, self.config.n_shards,
            dtype=self.state.free_cores.dtype, device=self.device))

    @property
    def emergency(self):
        """The emergency state, stacked (N, ...) on the pipeline's device;
        applies queued cap windows first. Assigning one puts it back on
        the mesh."""
        self._flush_caps()
        return self._stacked(self._emergency)

    @emergency.setter
    def emergency(self, value):
        self._emergency = self._on_mesh(value)

    @property
    def balloon_state(self):
        """The balloon state, stacked on the pipeline's device."""
        self._flush_caps()
        return self._stacked(self._balloon)

    def _total_ballooned_gb(self) -> float:
        return ballooning.total_ballooned_gb(self._stacked(self._balloon))

    @property
    def adaptive_state(self):
        """The controllers' state, stacked on the pipeline's device."""
        return self._stacked(self._adaptive)

    @property
    def adaptive_ratio(self) -> np.ndarray:
        """(N,) per-shard oversubscription ratios (all 1.0 with the
        controller off): each shard adapts the budget slice it owns."""
        if self._adaptive is None:
            return np.ones(self.config.n_shards)
        return self.adaptive_state.ratio.cpu().numpy()

    def _adaptive_scan(self, chassis, power_w) -> None:
        """Step every shard's controller on one unique-chassis window."""
        self._count_dispatch("adaptive_sharded")
        self._adaptive, out = sharding.apply_adaptive_sharded(
            self.adaptive_cfg, self.sharded, self._adaptive, chassis,
            power_w)
        self._apply_ratio(out)

    def _axis_mult(self, dtype) -> torch.Tensor:
        """(N, R) multipliers: each shard's ratio on the watts axis, the
        shared time-of-day ratios on cores/GB, on the pipeline's
        device."""
        ones = torch.ones(self.config.n_shards, dtype=dtype,
                          device=self.device)
        r = ones if self._ratio_dev is None \
            else self._ratio_dev.to(self.device, dtype)
        return torch.stack([r, ones, ones], -1) * torch.as_tensor(
            self._res_ratios, dtype=dtype, device=self.device)

    def _refresh_caps(self) -> None:
        """Put the current multipliers in force: rescale each shard's
        ceiling and retarget its free pool against its committed ledger
        (`adaptive.retarget_pool` floors it at 0, so tokens committed to
        placed VMs are never revoked). The ledger is summed over the
        shard's chassis in numpy's order, so the pools repeat on the card."""
        mult = self._axis_mult(self._sharded_cap_base.dtype)
        groups = []
        for g, blk in zip(sharding.groups_of(self.sharded),
                          sharding.shard_blocks(self.sharded)):
            dev = g.pool.device
            m = mult[blk].to(dev)
            pool = g.pool
            if self._pool_base is not None:
                committed = emergency._numpy_order_sum(g.shards.res_peak, -2)
                pool = adaptive.retarget_pool(
                    self.adaptive_cfg, self._pool_base[blk].to(dev), m,
                    committed)
            groups.append(g._replace(
                res_cap=self._sharded_cap_base[blk].to(dev) * m[:, None, :],
                pool=pool))
        self.sharded = sharding.regroup(self.sharded, groups)

    def _record_adaptive(self, out) -> None:
        """Per-shard export of one controller decision: a shard-labelled
        ratio gauge, the summed step counters and one reason row per
        shard."""
        if self.obs is None:
            return
        reg = self.obs.registry
        ratios = out.ratio.cpu().numpy()
        ratchets = out.ratchet.cpu().numpy()
        backoffs = out.backoff.cpu().numpy()
        for i, r in enumerate(ratios):
            reg.gauge("adaptive_ratio",
                      help="oversubscription ratio of the adaptive "
                      "controller", shard=str(i)).set(float(r))
        reg.counter("adaptive_ratchet_total",
                    help="adaptive-controller up-steps taken").inc(
                        int(ratchets.sum()))
        reg.counter("adaptive_backoff_total",
                    help="adaptive-controller down-steps taken").inc(
                        int(backoffs.sum()))
        if self.obs.adaptive is not None:
            now = time.time()
            n_known = out.n_known.cpu().numpy()
            n_stable = out.n_stable.cpu().numpy()
            frac = out.stable_frac.cpu().numpy()
            hot = out.hot.cpu().numpy()
            for i in range(len(ratios)):
                self.obs.adaptive.record(
                    t=now, shard=i, ratio=float(ratios[i]),
                    stable_frac=float(frac[i]), n_known=int(n_known[i]),
                    n_stable=int(n_stable[i]),
                    action=1 if ratchets[i] else
                    (-1 if backoffs[i] else 0),
                    reason=adaptive.decision_reason(
                        float(self._ratio_prev[i]), float(ratios[i]),
                        int(n_known[i]), bool(ratchets[i]),
                        bool(backoffs[i]), bool(hot[i])))
        self._ratio_prev = ratios

    def _cap_window(self, chassis, power_w, t):
        """One unique-chassis window on every shard at once, through the
        balloon step first when the rung is attached."""
        if self._balloon is not None:
            self._count_dispatch("balloon_caps_sharded")
            (self._emergency, self._balloon, out,
             bout) = sharding.apply_caps_ballooned_sharded(
                self.emergency_cfg, self.config.planes.ballooning,
                self.sharded, self._emergency, self._balloon, chassis,
                power_w, t)
            self._record_balloon(bout)
            return out
        self._count_dispatch("caps_sharded")
        self._emergency, out = sharding.apply_caps_sharded(
            self.emergency_cfg, self.sharded, self._emergency, chassis,
            power_w, t)
        return out

    def _dwell_mask(self, mask: np.ndarray) -> np.ndarray:
        return mask.reshape(self.config.n_shards, -1)

    # -- diagnostics ----------------------------------------------------------
    def global_state(self) -> placement.DeviceClusterState:
        """The sharded aggregates as one cluster state, on the pipeline's
        device."""
        return sharding.unshard_state(self.sharded, self.device)

    def chassis_headroom_w(self, budget_w) -> np.ndarray:
        return admission.headroom_w(self.global_state(), budget_w,
                                    self.blades_per_chassis)

    def pool_left(self) -> np.ndarray:
        """(N,) tokens left per shard, rho units: the watts axis of
        `pool_left_vec`."""
        return sharding.pool_left(self.sharded)[:, 0]

    def pool_left_vec(self) -> np.ndarray:
        """(N, R) tokens left per shard and axis (+inf where unbudgeted)."""
        return sharding.pool_left(self.sharded)
