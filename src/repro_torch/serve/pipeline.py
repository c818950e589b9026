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

The cluster token pool and the observability plane are later parts of
the port (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.placement import SchedulerPolicy
from repro_torch.core.predictor import UF, PredictionService
from repro_torch.core.resources import N_RESOURCES, RESOURCES, ResourceVector
from repro_torch.device import resolve_device
from repro_torch.serve import (adaptive, admission, ballooning, emergency,
                               placement)
from repro_torch.serve.featurizer import (
    SubscriptionTable, featurize_batch, ingest_population, table_from_history)
from repro_torch.serve.inference import (
    bucket_to_p95_torch, pack_service, served_query)
from repro_torch.serve.ingest import (
    ARRIVAL, CAPPING, CapBatch, DepartureBatch, IngestMux, MergedEvents,
    slice_soa)
from repro_torch.sim.telemetry import ArrivalBatch, Population

#: PlaneBundle fields not carried yet -> the ROADMAP.md Queue 1 item that
#: ports them.
_LATER_PLANES = {
    "cluster_budget": "Queue 1 item 10 (sharded serving)",
    "obs": "Queue 1 item 11 (observability)",
}


@dataclass(frozen=True)
class PlaneBundle:
    """Control-plane attachments of a pipeline. This part of the port
    carries `chassis_budget`, the per-chassis admission budget as a
    `ResourceVector` (the watts axis converts through the power model
    into the rho ceiling, cores/GB axes are ledger currency);
    `emergency`, the power-emergency plane's `EmergencyConfig`;
    `ballooning`, the rung between capping and migration (it requires
    `emergency`: it sizes its reclaim with the emergency plane's alarm
    arithmetic); and `adaptive`, the closed-loop oversubscription
    controller. Setting `cluster_budget` or `obs` raises
    NotImplementedError naming the ROADMAP item."""
    chassis_budget: ResourceVector | None = None
    cluster_budget: object = None
    emergency: emergency.EmergencyConfig | None = None
    adaptive: adaptive.AdaptiveConfig | None = None
    ballooning: ballooning.BallooningConfig | None = None
    obs: object = None

    def __post_init__(self):
        for name, item in _LATER_PLANES.items():
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"PlaneBundle.{name} is not ported yet: ROADMAP.md "
                    f"{item}")


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
    def n_conservative(self) -> int:
        return int(self.conservative.sum())


def _concat_results(parts: list) -> ServeResult:
    return ServeResult(*(np.concatenate([getattr(p, f) for p in parts])
                         for f in ("server", "workload_type", "p95_bucket",
                                   "p95_eff", "conservative")))


def _concat_batches(parts: list) -> ArrivalBatch:
    return ArrivalBatch(*(np.concatenate([getattr(p, f) for p in parts])
                          for f in ArrivalBatch.__dataclass_fields__))


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
            self._balloon = ballooning.init_ballooning(
                self.n_chassis, dtype=state.free_cores.dtype,
                device=self.device)
        # adaptive controller: samples feed per-chassis stability windows,
        # and the stepped ratio rescales the admission ceiling
        self.adaptive_cfg = planes.adaptive
        self._adaptive = None
        self._res_cap_base = self.res_cap
        # (R,) time-of-day multipliers of the cores/GB axes
        # (`set_resource_ratios`); the watts axis stays 1.0
        self._res_ratios = np.ones(N_RESOURCES)
        self._ratio_dev = None      # adaptive ratio, a device scalar
        if self.adaptive_cfg is not None:
            acfg = self.adaptive_cfg
            if acfg.blades_per_chassis != self.blades_per_chassis:
                raise ValueError(
                    f"adaptive blades_per_chassis="
                    f"{acfg.blades_per_chassis} does not match the "
                    f"pipeline's {self.blades_per_chassis}: power samples "
                    "would read back as the wrong utilization")
            self._adaptive = adaptive.init_adaptive(
                acfg, self.n_chassis, dtype=state.free_cores.dtype,
                device=self.device)

    @property
    def rho_cap(self) -> torch.Tensor:
        """(C,) watt-axis admission ceiling (rho units)."""
        return self.res_cap[..., 0]

    def _init_emergency(self) -> emergency.EmergencyState:
        """Fresh per-chassis emergency state in the state's dtype."""
        return emergency.init_emergency(
            self.n_chassis, dtype=self.state.free_cores.dtype,
            device=self.device)

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

    @classmethod
    def from_history(cls, service: PredictionService, history: Population,
                     uf_labels, n_servers: int, cores_per_server: int,
                     blades_per_chassis: int,
                     table_capacity: int | None = None,
                     config: ServeConfig | None = None,
                     device=None) -> "ServePipeline":
        """Bootstrap table + empty cluster on `device` (the card unless
        ``device="cpu"``) from an offline labeled history."""
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
                   blades_per_chassis=blades_per_chassis)

    def hot_swap(self, new_service: PredictionService) -> None:
        """Pack the retrained forests into the standby buffer, then flip.
        Calls between pack and flip keep using the old model."""
        standby = 1 - self._active
        self._buffers[standby] = pack_service(new_service, self.device)
        self._active = standby
        self.swaps += 1

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
        self.ingest.submit_to(host, batch, t)
        return self._drain_events(self.ingest.poll())

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
        self.ingest.depart_to(host, DepartureBatch(
            np.asarray(servers, np.int32), np.asarray(cores, np.float32),
            np.asarray(p95_eff, np.float32), np.asarray(is_uf, bool),
            None if mem_gb is None else np.asarray(mem_gb, np.float32)), t)
        return self._drain_events(self.ingest.poll())

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
        self.ingest.cap_to(host, CapBatch(
            np.asarray(chassis, np.int32),
            np.asarray(power_w, np.float32)), t)
        return self._drain_events(self.ingest.poll())

    def flush(self) -> ServeResult | None:
        """Serve everything still queued, watermark ignored (padded up to
        the batch size; chunked if the drain releases more than one
        micro-batch), and apply trailing cap windows. Returns one
        concatenated result, or None."""
        out = self._drain_events(self.ingest.drain())
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
        any micro-batch served after them)."""
        bs = self.config.batch_size
        out: list[ServeResult] = []
        pos = 0
        for kind, lo, hi in events.runs():
            t_run = events.t[pos:pos + (hi - lo)]
            pos += hi - lo
            if kind == CAPPING:
                self._apply_caps(slice_soa(events.caps, lo, hi), t_run)
                continue
            if kind != ARRIVAL:
                d = slice_soa(events.departures, lo, hi)
                self._apply_departures(d.server, d.cores, d.p95_eff,
                                       d.is_uf, d.mem_gb)
                continue
            self._pending.append(slice_soa(events.arrivals, lo, hi))
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
        micro-batches of the configured size."""
        bs = self.config.batch_size
        if len(batch) <= bs:
            return self._serve_padded(batch)
        parts = [ArrivalBatch(*(getattr(batch, f)[i:i + bs]
                                for f in ArrivalBatch.__dataclass_fields__))
                 for i in range(0, len(batch), bs)]
        return _concat_results([self._serve_padded(p) for p in parts])

    def _serve_padded(self, batch: ArrivalBatch) -> ServeResult:
        b = len(batch)
        pad_to = self.config.batch_size
        packed, meta = self._buffers[self._active]
        x = featurize_batch(self.table, batch, pad_to=pad_to)
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
        servers = self._place(padded(batch.cores), is_uf, p95_eff, valid,
                              padded(batch.memory_gb))
        self.served += b
        host = [a[:b].cpu().numpy() for a in (
            servers, q["workload_type_used"], q["p95_bucket_used"],
            p95_eff, q["conservative"])]
        return ServeResult(*host)

    def _place(self, cores, is_uf, p95_eff, valid, mem):
        """Placement stage of one padded micro-batch: Algorithm 1 with
        power admission against the cluster state; returns the (B,)
        decisions (FAIL_* codes on reject). Cap windows queued since the
        last batch are applied first (`placement.place_batch_caps`)."""
        if self._pending_caps:
            pw, mask, ts = self._stacked_caps()
            self._pending_caps = []
            (self.state, servers, self._emergency,
             sweep) = placement.place_batch_caps(
                self.state, self._emergency, pw, mask, ts, cores, is_uf,
                p95_eff, valid, self.res_cap, self.config.policy,
                self.cores_per_server, self.emergency_cfg, mem_gb=mem)
            self._alarms += int(sweep.alarms)
            return servers
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
            out = self._cap_window(chassis, power_w, t)
            self._alarms += int(out.alarm.sum())

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
            self._balloon, bout = ballooning.balloon_step(
                self.config.planes.ballooning, self.emergency_cfg,
                self._balloon, rho_lv, pw, self.state.mem_nuf, mask)
            pw = bout.power_adj_w
        self._emergency, out = emergency.masked_step(
            self.emergency_cfg, self._emergency, rho_lv, pw, mask, ts)
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
        return ballooning.total_ballooned_gb(self._balloon)

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
        self._adaptive, out = adaptive.adaptive_step(
            self.adaptive_cfg, self._adaptive, rho_lv, pw, mask)
        self._apply_ratio(out)

    def _apply_ratio(self, out) -> None:
        """Scale the watt axis of the admission ceiling by the stepped
        ratio, on the device (no host sync). `hold_on_stale` needs the
        prediction scorecard of the observability plane, not ported yet,
        and has no effect here."""
        self._ratio_dev = out.ratio
        self._refresh_caps()

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
