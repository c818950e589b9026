"""Cluster VM-scheduler simulation (paper §IV-E, Fig. 7), the
counterpart of `repro.sim.scheduler_sim`.

Event-driven 30-day simulation of a 20-rack x 3-chassis x 12-blade
cluster. Like Azure's simulator, it runs the *actual* placement code
(`core.placement`) for every arrival; the only extension is the
simulated prediction channel (the paper's only extension was simulating
calls to the ML system).

Reported metrics (paper's four):
  * deployment failure rate,
  * average empty-server ratio,
  * std-dev across chassis of the chassis score 1 - rho_peak/rho_max,
  * std-dev across servers of the server score .5(1+(gNUF-gUF)/N).

The placements the scheduler produced can be fed to the fleet engine
(`sim.fleet`) to measure the *capping dynamics* they induce —
`evaluate_power_dynamics` runs the chassis simulator across the live
chassis layouts in one batched run.

`simulate` runs the `event` backend (the per-arrival numpy rule, the
decision oracle) and the `serve` backend (each deployment group through
`serve.placement.place_batch` on the card, in float64). The random
stream is the reference's draw for draw, so the same seed gives the same
arrivals, predictions and decisions. `SimSpec.emergency` drives the
power-emergency plane (`_EmergencySim`) at every deployment event, with
`SimSpec.ballooning` its ballooning rung; `SimSpec.adaptive` drives the
adaptive-ratio controller (`_AdaptiveSim`), whose ratio scales the serve
backend's watt ceiling. Not ported yet: the `serve-sharded` backend
(ROADMAP Queue 1 item 10), the observability hooks (item 11), and the
deprecated flat-keyword adapter of the reference's `simulate`.
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core.placement import ClusterState, SchedulerPolicy
from repro_torch.core.resources import (N_RESOURCES, ResourceVector,
                                        trough_ratios)
from repro_torch.device import resolve_device
from repro_torch.sim import telemetry as tel
from repro_torch.sim.fleet import (ServerSpec, VMSpec, build_layout,
                                   build_uf_traces, run_fleet_layouts,
                                   stack_layouts)

if TYPE_CHECKING:
    from repro_torch.serve.adaptive import AdaptiveConfig
    from repro_torch.serve.ballooning import BallooningConfig
    from repro_torch.serve.emergency import EmergencyConfig

CORES_PER_BLADE = 40            # Table I: 2 x 20 cores
BLADES_PER_CHASSIS = 12
CHASSIS_PER_RACK = 3
RACKS = 20

#: Deterministic GB-per-vcore of every simulated VM. Memory demand is
#: a pure function of the core draw, so the GB ledger consumes NO extra
#: randomness.
GB_PER_CORE = 4.0


@dataclass(frozen=True)
class PredictionChannel:
    """Simulated ML-system responses (Table III operating point).

    mode:
      'oracle'    — perfect workload type and P95 bucket;
      'ml'        — criticality flipped w.p. its measured error, P95
                    bucket resampled w.p. its measured error; low-
                    confidence queries fall back to conservative values
                    (UF, bucket 4), as the real scheduler does;
      'crit_only' — criticality as 'ml', utilization assumed 100 %
                    (Fig 7 orange bars);
      'none'      — no predictions (NoRule baseline ignores them).
    """
    mode: str = "ml"
    crit_recall_uf: float = 0.99     # P(pred UF | true UF)   — Table III
    crit_recall_nuf: float = 0.69    # P(pred NUF | true NUF)
    p95_accuracy: float = 0.84
    p95_high_conf: float = 0.73

    def predict(self, rng, true_uf: bool, true_p95: float):
        if self.mode == "oracle":
            return true_uf, true_p95
        if true_uf:
            uf = rng.random() < self.crit_recall_uf
        else:
            uf = not (rng.random() < self.crit_recall_nuf)
        if self.mode == "crit_only":
            return uf, 1.0
        if rng.random() > self.p95_high_conf:
            return uf, 1.0                       # low confidence -> 100 %
        if rng.random() < self.p95_accuracy:
            p95 = true_p95
        else:
            p95 = float(np.clip(true_p95 + rng.choice([-0.25, 0.25]),
                                0.125, 0.875))
        return uf, p95


@dataclass(frozen=True)
class PowerEvalSpec:
    """Post-run capping-dynamics evaluation (`evaluate_power_dynamics`
    over the placements the scheduler produced). ``budget_w`` is the
    per-chassis watt budget the fleet engine enforces; ``backend``
    'torch' runs the engine on `simulate`'s device, 'numpy' the
    oracle."""
    budget_w: float
    chassis: int = 8
    duration_s: float = 60.0
    backend: str = "torch"

    def __post_init__(self):
        if not self.budget_w > 0:
            raise ValueError(
                f"PowerEvalSpec.budget_w must be > 0, got {self.budget_w}")


@dataclass(frozen=True)
class ServeBackendSpec:
    """Which placement path runs, and the resource budgets it admits
    against (DESIGN.md §16).

    backend:          'event' | 'serve' | 'serve-sharded' (see
                      `simulate`; 'serve-sharded' is not ported yet).
    admission_budget: per-chassis `ResourceVector` ceiling for the
                      serve path (None = unbounded).
    cluster_budget:   global `ResourceVector` the sharded token pools
                      enforce.
    shards:           state partitions of the sharded protocol.
    ingest_hosts:     per-host queues the arrival stream is dealt
                      over (sharded backend only).
    diurnal_ratchet:  condition the cores/GB admission ceilings (and
                      sharded pool axes) on the diurnal trough via
                      `core.resources.trough_ratios` — Coach-style
                      time-of-day oversubscription; the watts axis is
                      a breaker limit and never ratchets.
    """
    backend: str = "event"
    admission_budget: ResourceVector | None = None
    cluster_budget: ResourceVector | None = None
    shards: int = 1
    ingest_hosts: int = 1
    diurnal_ratchet: bool = False

    def __post_init__(self):
        if self.backend not in ("event", "serve", "serve-sharded"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.ingest_hosts < 1:
            raise ValueError(f"ingest_hosts must be >= 1, "
                             f"got {self.ingest_hosts}")


@dataclass(frozen=True)
class SimSpec:
    """Everything `simulate` needs beyond the policy and the
    prediction channel — the one front door (DESIGN.md §16). Plane
    configs nest as typed sub-specs instead of a flat kwarg sprawl:
    ``serve`` picks the placement path and budgets, ``power`` the
    post-run capping evaluation, and ``emergency``/``adaptive``/
    ``ballooning`` the online planes (ballooning requires emergency, and
    adaptive a serve backend).
    """
    days: float = 30.0
    seed: int = 0
    deployments_per_hour: float = 8.0
    target_uf_core_ratio: float = 0.40
    sample_every_h: float = 2.0
    prefill_core_ratio: float = 0.0
    serve: ServeBackendSpec = field(default_factory=ServeBackendSpec)
    power: PowerEvalSpec | None = None
    emergency: EmergencyConfig | None = None
    adaptive: AdaptiveConfig | None = None
    ballooning: BallooningConfig | None = None

    def __post_init__(self):
        if not self.days > 0:
            raise ValueError(f"days must be > 0, got {self.days}")
        if self.ballooning is not None and self.emergency is None:
            raise ValueError(
                "SimSpec.ballooning requires SimSpec.emergency — the "
                "balloon rung fires on the emergency plane's alarms")


@dataclass
class PowerEval:
    """Capping dynamics of scheduler-produced placements (fleet engine)."""
    chassis_ids: np.ndarray             # (B,) evaluated chassis
    uf_p95_latency: np.ndarray          # (B,)
    nuf_slowdown: np.ndarray            # (B,)
    rapl_engaged_frac: np.ndarray       # (B,)
    alert_frac: np.ndarray              # (B,)
    power_max_w: np.ndarray             # (B,)


@dataclass
class SimMetrics:
    failure_rate: float
    empty_server_ratio: float
    chassis_score_std: float
    server_score_std: float
    placements: int
    failures: int
    power: PowerEval | None = None
    #: power-emergency plane counters (`SimSpec.emergency` runs only):
    #: per-criticality throttled-seconds — the paper's Table-4-style
    #: impact axis (critical should stay near zero under
    #: criticality-aware apportionment) — plus alarm and migration
    #: counts. `throttled_s` is (L,) in the emergency plane's level
    #: order (index `serve.emergency.CRIT_NUF` = 0, `CRIT_UF` = 1 —
    #: the `obs.LEVEL_NAMES` order), matching `EmergencyState.
    #: throttled_s` instead of the historical pair of drifting scalar
    #: names; those survive as read-only properties.
    throttled_s: np.ndarray = field(default_factory=lambda: np.zeros(2))
    alarms: int = 0
    migrations: int = 0
    #: ballooning rung (`SimSpec.ballooning` runs only): inflation
    #: events, total GB reclaimed across the run, and the GB still
    #: ballooned out at the end — all 0 when the rung is off
    balloon_events: int = 0
    balloon_reclaimed_gb: float = 0.0
    ballooned_gb: float = 0.0
    #: adaptive-ratio controller (`SimSpec.adaptive` runs only): the final
    #: oversubscription ratio and the up/down step counts — 1.0/0/0
    #: when the controller is off
    adaptive_ratio: float = 1.0
    adaptive_ratchets: int = 0
    adaptive_backoffs: int = 0
    #: measured predicted-vs-realized labels (DESIGN.md §17): every
    #: `PredictionChannel.predict` call is scored against the ground
    #: truth it was sampled from — ``crit_confusion[true, pred]``
    #: (2, 2) over criticality, ``p95_confusion[true, pred]`` (4, 4)
    #: over P95 buckets. Accuracy is an *output* of the run, not the
    #: channel's generative constant (`measured_p95_accuracy` vs the
    #: assumed ``p95_accuracy`` knob).
    crit_confusion: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 2), np.int64))
    p95_confusion: np.ndarray = field(
        default_factory=lambda: np.zeros((4, 4), np.int64))

    @property
    def measured_crit_accuracy(self) -> float:
        """Realized criticality-prediction accuracy over the run
        (NaN when nothing was scored)."""
        n = self.crit_confusion.sum()
        return float(np.trace(self.crit_confusion) / n) if n \
            else float("nan")

    @property
    def measured_p95_accuracy(self) -> float:
        """Realized P95-bucket-prediction accuracy over the run
        (NaN when nothing was scored)."""
        n = self.p95_confusion.sum()
        return float(np.trace(self.p95_confusion) / n) if n \
            else float("nan")

    @property
    def nuf_throttled_s(self) -> float:
        """Non-critical throttled-seconds (``throttled_s[CRIT_NUF]``)."""
        return float(self.throttled_s[0])

    @property
    def uf_throttled_s(self) -> float:
        """Critical throttled-seconds (``throttled_s[CRIT_UF]``)."""
        return float(self.throttled_s[1])


def evaluate_power_dynamics(vm_live: dict, chassis_of: np.ndarray,
                            n_chassis: int, budget_w: float,
                            blades_per_chassis: int = BLADES_PER_CHASSIS,
                            cores_per_blade: int = CORES_PER_BLADE,
                            sample_chassis: int = 8,
                            duration_s: float = 60.0, seed: int = 0,
                            backend: str = "torch",
                            device=None) -> PowerEval:
    """Run the fleet engine on the placements the scheduler produced.

    Picks the `sample_chassis` most-allocated chassis, packs each one's
    live VMs into padded fleet layouts (UF VMs' offered load = their
    effective P95), and simulates the per-VM capping stack on all of
    them in one batched run. Different chassis have different VM
    placements — the layout arrays are the batch axis. `backend`
    'torch' runs on `device` (None: the card, raising without one);
    'numpy' runs the oracle on the host.
    """
    per_server = defaultdict(list)
    alloc = np.zeros(n_chassis)
    for (srv, cores, p95e, ufp, *_mem) in vm_live.values():
        per_server[srv].append(VMSpec(int(cores), bool(ufp),
                                      load=float(p95e)))
        alloc[chassis_of[srv]] += cores
    picked = np.argsort(-alloc)[:sample_chassis]
    picked = picked[alloc[picked] > 0]

    def chassis_specs(c):
        servers = np.nonzero(chassis_of == c)[0]
        return [ServerSpec(vms=per_server.get(int(s), []),
                           n_cores=cores_per_blade) for s in servers]

    all_specs = [chassis_specs(c) for c in picked]
    pad_uf = max(1, max(sum(v.is_uf for s in sp for v in s.vms)
                        for sp in all_specs))
    pad_nuf = max(1, max(sum(not v.is_uf for s in sp for v in s.vms)
                         for sp in all_specs))
    layouts = [build_layout(sp, pad_uf_to=pad_uf, pad_nuf_to=pad_nuf,
                            pad_cores_to=cores_per_blade)
               for sp in all_specs]
    n_steps = int(duration_s / 0.2)
    traces = np.stack([build_uf_traces(lo, n_steps, seed + i)
                       for i, lo in enumerate(layouts)])
    la = stack_layouts(layouts)
    res = run_fleet_layouts(
        la, np.stack([lo.uf_valid for lo in layouts]),
        np.stack([lo.nuf_valid for lo in layouts]),
        np.stack([lo.nuf_cores for lo in layouts]),
        np.full(len(layouts), budget_w), "per_vm", traces,
        backend=backend, device=device)
    return PowerEval(chassis_ids=picked,
                     uf_p95_latency=res.uf_p95_latency,
                     nuf_slowdown=res.nuf_slowdown,
                     rapl_engaged_frac=res.rapl_engaged_frac,
                     alert_frac=res.alert_frac,
                     power_max_w=res.power_w.max(-1))


def _sample_vm(rng):
    cores = int(rng.choice(tel.CORE_SIZES, p=tel.CORE_PROBS))
    life_h = tel._sample_bucket(rng, tel.LIFETIME_BUCKETS,
                                tel.LIFETIME_PROBS)
    return cores, life_h


def _sample_deployment_size(rng):
    return int(tel._sample_bucket(rng, tel.DEPLOY_SIZE_BUCKETS,
                                  tel.DEPLOY_SIZE_PROBS))


#: Serve-backend micro-batch pad (max deployment size is 60 — Table I).
SERVE_GROUP_PAD = 64


def _rho_levels(state, chassis_of: np.ndarray, n_chassis: int) -> np.ndarray:
    """(C, L) committed p95*cores per chassis and criticality level of a
    host `ClusterState` (non-critical level first)."""
    return np.stack(
        [np.bincount(chassis_of, weights=state.gamma_nuf,
                     minlength=n_chassis),
         np.bincount(chassis_of, weights=state.gamma_uf,
                     minlength=n_chassis)], axis=-1)


def _check_twin(oracle, twin, what: str) -> None:
    """Raise unless every field of the torch twin's state is bit-equal to
    the numpy oracle's."""
    for name, a, b in zip(oracle._fields, oracle, twin):
        if not np.array_equal(a, b.cpu().numpy()):
            raise RuntimeError(
                f"{what} twin diverged from the numpy oracle in {name}")


class _EmergencySim:
    """The power-emergency plane driven inside `simulate`.

    Holds one fleet-wide float64 `serve.emergency.EmergencyState` and
    steps it at every deployment event: the committed per-criticality
    aggregates, scaled by the deterministic diurnal utilization sample
    (`sim.telemetry.diurnal_util`), give each chassis' power sample; with
    a `BallooningConfig` the ballooning rung absorbs first what the NUF
    floor cannot; the alarm and apportionment step consumes the samples;
    chassis whose critical level dwells capped past the threshold get a
    migration plan (`serve.mitigation`) applied to the cluster state as
    paired moves.

    The numpy oracle decides. With a `device` (the serve backend) every
    scan also steps the torch twins there in float64 and raises unless
    they are bit-equal to the oracle: the acceptance invariant, checked
    on every scan. The samples are a pure function of simulation time, so
    the emergency trace is the same for every backend."""

    def __init__(self, cfg: EmergencyConfig, n_chassis: int,
                 chassis_of: np.ndarray, device=None,
                 bcfg: BallooningConfig | None = None):
        # `repro_torch.serve` imports this package's telemetry, so the
        # plane's modules are imported when a plane is built
        from repro_torch.serve import ballooning, emergency, mitigation
        self.emg, self.mit, self.bal = emergency, mitigation, ballooning
        self.cfg = cfg
        self.bcfg = bcfg
        self.n_chassis = n_chassis
        self.chassis_of = chassis_of
        self.device = device
        self.st = emergency.init_emergency_np(n_chassis, dtype=np.float64)
        self.bst = None if bcfg is None else \
            ballooning.init_ballooning_np(n_chassis, dtype=np.float64)
        self.alarms = 0
        self.migrations = 0
        self.balloon_events = 0
        self.balloon_reclaimed_gb = 0.0

    def _rho_lv(self, state) -> np.ndarray:
        return _rho_levels(state, self.chassis_of, self.n_chassis)

    def scan(self, t_h: float, state, vm_live: dict,
             mem_nuf: np.ndarray = None, mem_chassis: np.ndarray = None,
             gb_cap: np.ndarray = None) -> None:
        """One emergency scan at simulation time `t_h` (hours).
        `mem_nuf`/`mem_chassis`: (C,) committed GB (NUF slice and total),
        the ballooning rung's headroom and the migration planner's GB-fit
        ledger; `gb_cap`: (C,) chassis GB capacity (None disables the
        destination GB-fit check)."""
        emg = self.emg
        u = float(tel.diurnal_util(t_h))
        rho_lv = self._rho_lv(state)
        idx = np.arange(self.n_chassis)
        stamps = t_h * 3600.0 + (idx + 1) * 1e-7
        power = np.asarray(emg.sampled_power_np(
            self.cfg, rho_lv, u, np.zeros((self.n_chassis, 2), np.int32),
            np.zeros(self.n_chassis, bool)))
        pw, mask, ts = emg.scatter_samples_np(self.n_chassis, idx, power,
                                              stamps, np.float64)
        # ballooning rung: absorb the deficit the NUF floor cannot, by
        # powering NUF DRAM down, before the capping step reads the sample
        bst2 = bout = None
        pw_step = pw
        nuf = np.zeros(self.n_chassis) if mem_nuf is None else mem_nuf
        if self.bst is not None:
            bst2, bout = self.bal.balloon_step_np(
                self.bcfg, self.cfg, self.bst, rho_lv, pw, nuf, mask)
            pw_step = bout.power_adj_w
        st2, out = emg.masked_step_np(self.cfg, self.st, rho_lv, pw_step,
                                      mask, ts)
        if self.device is not None:
            def dev(a):
                return torch.as_tensor(a, device=self.device)
            pw_twin = dev(pw)
            if self.bst is not None:
                bst_twin, bout_twin = self.bal.balloon_step(
                    self.bcfg, self.cfg,
                    self.bal.state_to_torch(self.bst, self.device),
                    dev(rho_lv), pw_twin, dev(nuf), dev(mask))
                _check_twin(bst2, bst_twin, "ballooning")
                pw_twin = bout_twin.power_adj_w
            twin, _ = emg.masked_step(
                self.cfg, emg.state_to_torch(self.st, self.device),
                dev(rho_lv), pw_twin, dev(mask), dev(ts))
            _check_twin(st2, twin, "emergency")
        self.st = st2
        if bst2 is not None:
            self.bst = bst2
            self.balloon_events += int(bout.inflated.sum())
            self.balloon_reclaimed_gb += float(bout.reclaimed_gb.sum())
        self.alarms += int(out.alarm.sum())
        # no chassis past the alarm window may exceed its budget when the
        # cut was achievable within the floors (the RAPL-leftover rows
        # are pinned at the all-core frequency floor)
        achievable = out.alarm & (out.leftover_w <= 1e-6)
        if not (out.power_after_w[achievable]
                <= self.cfg.chassis_budget_w + 1e-6).all():
            raise RuntimeError(
                "chassis exceeded its budget past the alarm window")
        self._mitigate(u, state, vm_live, mem_chassis, gb_cap)

    def _mitigate(self, u: float, state, vm_live: dict,
                  mem_chassis: np.ndarray = None,
                  gb_cap: np.ndarray = None) -> None:
        emg, mit = self.emg, self.mit
        due = np.asarray(emg.mitigation_due_np(self.cfg, self.st))
        if not due.any() or not vm_live:
            return
        tokens = np.fromiter(vm_live.keys(), np.int64, len(vm_live))
        tokens.sort()                       # deterministic registry order
        rows = [vm_live[int(k)] for k in tokens]
        live = mit.LiveVMs(
            server=np.array([r[0] for r in rows], np.int32),
            cores=np.array([r[1] for r in rows], np.float64),
            p95_eff=np.array([r[2] for r in rows], np.float64),
            is_uf=np.array([r[3] for r in rows], bool),
            token=tokens,
            mem_gb=np.array([r[4] for r in rows], np.float64))
        plan = mit.plan_migrations(
            self.cfg, live, self.chassis_of, state.free_cores,
            self._rho_lv(state), u, due,
            mem_chassis=mem_chassis, gb_cap=gb_cap)
        # paired depart/arrive moves; pairs touch disjoint VMs, so plan
        # order is any merged event order
        for m in range(len(plan)):
            cores = float(plan.cores[m])
            p95, uf = float(plan.p95_eff[m]), bool(plan.is_uf[m])
            mem = float(plan.mem_gb[m])
            src, dst = int(plan.src_server[m]), int(plan.dst_server[m])
            state.remove(src, cores, p95, uf)
            state.place(dst, cores, p95, uf)
            if mem_chassis is not None:
                mem_chassis[self.chassis_of[src]] -= mem
                mem_chassis[self.chassis_of[dst]] += mem
            vm_live[int(plan.token[m])] = (dst, cores, p95, uf, mem)
        self.migrations += len(plan)
        self.st = emg.reset_dwell_np(self.st, due)


class _AdaptiveSim:
    """The adaptive-ratio controller driven inside `simulate`.

    Holds one fleet-wide float64 `serve.adaptive.AdaptiveState` and steps
    it at every deployment event from the same diurnal samples the
    emergency plane reads, through `serve.adaptive.offered_power`. The
    ratio scales the serve backend's watt ceiling for the next placement
    scan: closed loop, one scan behind, like the pipeline's eager
    stepping. The numpy oracle decides; with a `device` every scan also
    steps the torch twin there and raises unless it is bit-equal."""

    def __init__(self, cfg: AdaptiveConfig, n_chassis: int,
                 chassis_of: np.ndarray, device=None):
        from repro_torch.serve import adaptive
        self.adp = adaptive
        self.cfg = cfg
        self.n_chassis = n_chassis
        self.chassis_of = chassis_of
        self.device = device
        self.st = adaptive.init_adaptive_np(cfg, n_chassis,
                                            dtype=np.float64)

    def _rho_lv(self, state) -> np.ndarray:
        return _rho_levels(state, self.chassis_of, self.n_chassis)

    @property
    def ratio(self) -> float:
        """Current fleet oversubscription ratio (starts at 1.0)."""
        return float(self.st.ratio)

    @property
    def ratchets(self) -> int:
        """Up-steps taken so far."""
        return int(self.st.ratchets)

    @property
    def backoffs(self) -> int:
        """Down-steps taken so far."""
        return int(self.st.backoffs)

    def scan(self, t_h: float, state) -> None:
        """One controller scan at simulation time `t_h` (hours)."""
        adp = self.adp
        u = float(tel.diurnal_util(t_h))
        rho_lv = self._rho_lv(state)
        power = np.asarray(adp.offered_power(self.cfg, rho_lv, u))
        mask = np.ones(self.n_chassis, bool)
        st2, _ = adp.adaptive_step_np(self.cfg, self.st, rho_lv, power,
                                      mask)
        if self.device is not None:
            def dev(a):
                return torch.as_tensor(a, device=self.device)
            twin, _ = adp.adaptive_step(
                self.cfg, adp.state_to_torch(self.st, self.device),
                dev(rho_lv), dev(power), dev(mask))
            _check_twin(st2, twin, "adaptive")
        self.st = st2


def _unported(spec: SimSpec, obs) -> None:
    """Raise for the parts of later slices, naming their ROADMAP item."""
    if spec.serve.backend == "serve-sharded":
        raise NotImplementedError(
            "backend='serve-sharded' is not ported yet (ROADMAP Queue 1 "
            "item 10)")
    if obs is not None:
        raise NotImplementedError(
            "obs is not ported yet (ROADMAP Queue 1 item 11)")


def simulate(policy: SchedulerPolicy, channel: PredictionChannel,
             spec: SimSpec | None = None, *, trace: list | None = None,
             obs=None, device=None) -> SimMetrics:
    """Run the 30-day simulation. Table I parameters throughout:
    UF:NUF core ratio 4:6, UF P95 ~ 65 % (bucket 3), NUF ~ 44 %
    (bucket 2).

    ``spec``, a `SimSpec`, holds every run parameter. Every VM carries
    ``GB_PER_CORE`` GB per vcore (deterministic, so the rng stream is
    untouched); the committed GB ledger feeds the serve path's
    per-resource admission.

    serve.backend:
      'event' — the per-arrival numpy path (`SchedulerPolicy.choose`),
                the decision oracle; it needs no device;
      'serve' — each deployment group is placed by one call to the
                serving pipeline's batched scorer
                (`serve.placement.place_batch`, padded to
                SERVE_GROUP_PAD) on `device` in float64, which decides
                as the event rule does, decision for decision.
                `serve.admission_budget` adds per-chassis (watts, cores,
                GB) admission ceilings (rejections count as failures);
                `serve.diurnal_ratchet` scales their cores/GB axes by
                `core.resources.trough_ratios` of the diurnal sample.

    `device` is where the serve backend places and the power evaluation
    (`spec.power` with its 'torch' backend) runs: None means the card,
    and raises without one; pass ``device="cpu"`` to run there.

    `prefill_core_ratio` warm-starts the cluster before the event loop:
    VMs are sampled and placed by the event-path rule (identically for
    every backend) until that fraction of the fleet's cores is
    committed, with length-biased lifetimes feeding the departure heap.

    `trace`, if given, collects the chosen server (or failure code)
    per placement attempt — the decision-equivalence probe.

    `spec.emergency` steps the power-emergency plane before each
    deployment group (`_EmergencySim`; on the serve backend its torch
    twin also runs on `device`, held bit-equal to the numpy oracle) and
    fills `SimMetrics.throttled_s`, `alarms` and `migrations`;
    `spec.ballooning` adds the ballooning rung in front of it (the
    `balloon_*` fields). `spec.adaptive` needs a serve backend: it steps
    the adaptive controller (`_AdaptiveSim`, its twin checked the same
    way) after the emergency scan, and its ratio scales the watt ceiling
    of the group's placement (the `adaptive_*` fields).

    The 'serve-sharded' backend and `obs` raise `NotImplementedError`:
    they belong to later parts of the port."""
    spec = spec if spec is not None else SimSpec()
    _unported(spec, obs)
    sv = spec.serve
    backend_name = sv.backend
    if spec.adaptive is not None and backend_name == "event":
        # the controller scales the serve admission ceiling; the event
        # rule has none, so a ratio there would bind nothing
        raise ValueError("SimSpec.adaptive requires a serve backend")
    if sv.ingest_hosts != 1:
        raise ValueError(
            f"ingest_hosts={sv.ingest_hosts} requires "
            f"backend='serve-sharded', got {backend_name!r}")
    if sv.diurnal_ratchet and backend_name == "event":
        raise ValueError(
            "diurnal_ratchet conditions the serve admission ceilings; "
            "it requires a serve backend")
    serving = backend_name == "serve"
    dev = resolve_device(device) if serving or (
        spec.power is not None and spec.power.backend == "torch") else None
    if serving:
        from repro_torch.serve.admission import resource_caps_from_budget
        from repro_torch.serve.placement import device_state, place_batch
    from repro_torch.core.features import p95_bucket
    rng = np.random.default_rng(spec.seed)
    n_servers = RACKS * CHASSIS_PER_RACK * BLADES_PER_CHASSIS
    chassis_of = np.arange(n_servers) // BLADES_PER_CHASSIS
    state = ClusterState(
        n_servers=n_servers, cores_per_server=CORES_PER_BLADE,
        chassis_of_server=chassis_of,
        n_chassis=n_servers // BLADES_PER_CHASSIS)
    # committed-GB ledgers per chassis (total and NUF slice): the joint
    # admission's, the ballooning rung's and the planner's memory view
    mem_chassis = np.zeros(state.n_chassis)
    mem_nuf_chassis = np.zeros(state.n_chassis)
    gb_cap = None
    if serving:
        serve_res_cap = resource_caps_from_budget(
            sv.admission_budget or ResourceVector(),
            BLADES_PER_CHASSIS, state.n_chassis)
        gb_cap_col = serve_res_cap[:, 2].astype(np.float64)
        gb_cap = gb_cap_col if np.isfinite(gb_cap_col).any() else None
    emer = None
    if spec.emergency is not None:
        emer = _EmergencySim(spec.emergency, state.n_chassis, chassis_of,
                             device=dev if serving else None,
                             bcfg=spec.ballooning)
    adp = None
    if spec.adaptive is not None:
        adp = _AdaptiveSim(spec.adaptive, state.n_chassis, chassis_of,
                           device=dev)
    departures: list = []        # heap of (time, vm_token)
    # token -> (server, cores, p95eff, uf_pred, mem_gb)
    vm_live: dict = {}
    token = 0
    placements = failures = 0
    # measured predicted-vs-realized scoring: every channel.predict is
    # scored against the ground truth it was sampled from — consumes no
    # randomness and feeds nothing back into placement
    crit_cm = np.zeros((2, 2), np.int64)
    p95_cm = np.zeros((4, 4), np.int64)

    def _score(true_uf, true_p95, uf_pred, p95_pred):
        tb = int(p95_bucket(true_p95 * 100.0))
        pb = int(p95_bucket(p95_pred * 100.0))
        crit_cm[int(true_uf), int(uf_pred)] += 1
        p95_cm[tb, pb] += 1

    # warm start (identical for every backend: one rng prefix, the
    # event-path placement rule). A snapshot of a running fleet is
    # length-biased, so prefill lifetimes sample the duration-weighted
    # buckets with a uniform residual.
    target_cores = spec.prefill_core_ratio * n_servers * CORES_PER_BLADE
    mids = np.array([(lo + hi) / 2 for lo, hi in tel.LIFETIME_BUCKETS])
    standing_probs = tel.LIFETIME_PROBS * mids
    standing_probs = standing_probs / standing_probs.sum()
    filled = 0.0
    while filled < target_cores:
        cores = int(rng.choice(tel.CORE_SIZES, p=tel.CORE_PROBS))
        life_h = rng.random() * tel._sample_bucket(
            rng, tel.LIFETIME_BUCKETS, standing_probs)
        true_uf = rng.random() < spec.target_uf_core_ratio
        true_p95 = float(np.clip(
            rng.normal(0.65 if true_uf else 0.44, 0.12), 0.05, 1.0))
        uf_pred, p95_pred = channel.predict(rng, true_uf, true_p95)
        _score(true_uf, true_p95, uf_pred, p95_pred)
        p95_eff = policy.effective_p95(p95_pred)
        srv = policy.choose(state, cores, uf_pred)
        if srv is None:
            break
        mem = cores * GB_PER_CORE
        state.place(srv, cores, p95_eff, uf_pred)
        mem_chassis[chassis_of[srv]] += mem
        if not uf_pred:
            mem_nuf_chassis[chassis_of[srv]] += mem
        vm_live[token] = (srv, cores, p95_eff, uf_pred, mem)
        heapq.heappush(departures, (life_h, token))
        token += 1
        filled += cores
    t = 0.0
    next_sample = 0.0
    empty_samples, chassis_stds, server_stds = [], [], []
    horizon = spec.days * 24.0

    while t < horizon:
        t += rng.exponential(1.0 / spec.deployments_per_hour)
        # departures first
        while departures and departures[0][0] <= t:
            _, tok = heapq.heappop(departures)
            srv, cores, p95e, ufp, mem = vm_live.pop(tok)
            state.remove(srv, cores, p95e, ufp)
            mem_chassis[chassis_of[srv]] -= mem
            if not ufp:
                mem_nuf_chassis[chassis_of[srv]] -= mem
        while next_sample <= t and next_sample < horizon:
            busy = state.free_cores < CORES_PER_BLADE
            empty_samples.append(1.0 - busy.mean())
            chassis_stds.append(float(np.std(state.score_chassis())))
            server_stds.append(float(np.std(state.score_server(True))))
            next_sample += spec.sample_every_h
        if t >= horizon:
            break
        if emer is not None:
            emer.scan(t, state, vm_live, mem_nuf=mem_nuf_chassis,
                      mem_chassis=mem_chassis, gb_cap=gb_cap)
        if adp is not None:
            adp.scan(t, state)
        # sample the whole deployment group first (placement consumes
        # no randomness, so both backends see the same stream), then
        # place per-VM (event) or via one batched call (serve)
        group = []
        for _ in range(_sample_deployment_size(rng)):
            cores, life_h = _sample_vm(rng)
            true_uf = rng.random() < spec.target_uf_core_ratio
            true_p95 = float(np.clip(
                rng.normal(0.65 if true_uf else 0.44, 0.12), 0.05, 1.0))
            uf_pred, p95_pred = channel.predict(rng, true_uf, true_p95)
            _score(true_uf, true_p95, uf_pred, p95_pred)
            group.append((cores, life_h, uf_pred,
                          policy.effective_p95(p95_pred)))
        chosen = None
        if serving:
            n = len(group)
            assert n <= SERVE_GROUP_PAD, \
                "deployment group exceeds SERVE_GROUP_PAD"
            pad = np.zeros(SERVE_GROUP_PAD, np.float64)
            cores_a, uf_a, p95_a = pad.copy(), pad.copy(), pad.copy()
            for k, (cores, _, ufp, p95e) in enumerate(group):
                cores_a[k], uf_a[k], p95_a[k] = cores, ufp, p95e
            mem_a = cores_a * GB_PER_CORE
            valid = np.arange(SERVE_GROUP_PAD) < n
            # the controller's ratio (stepped just above, one scan behind)
            # scales the watt ceilings for this group's placement, and
            # the diurnal ratchet the cores/GB ceilings in the trough
            # (watts never ratchet: the breaker limit is physical); the
            # multiply stays in float32 like the reference's, so a
            # watt-only budget decides as it does
            ratio = 1.0 if adp is None else adp.ratio
            rrat = trough_ratios(float(tel.diurnal_util(t))) \
                if sv.diurnal_ratchet else np.ones(N_RESOURCES)
            cap_mult = np.asarray([ratio, rrat[1], rrat[2]], np.float32)
            _, srvs = place_batch(
                device_state(state, torch.float64, device=dev,
                             mem_gb=mem_chassis, mem_nuf=mem_nuf_chassis),
                cores_a,
                uf_a.astype(bool), p95_a, valid, serve_res_cap * cap_mult,
                policy, state.cores_per_server, mem_gb=mem_a)
            chosen = [int(s) for s in srvs.cpu().numpy()[:n]]
        for i, (cores, life_h, uf_pred, p95_eff) in enumerate(group):
            srv = chosen[i] if chosen is not None else \
                policy.choose(state, cores, uf_pred)
            placements += 1
            if trace is not None:
                trace.append(-1 if srv is None else int(srv))
            if srv is None or srv < 0:
                failures += 1
                continue
            mem = cores * GB_PER_CORE
            state.place(srv, cores, p95_eff, uf_pred)
            mem_chassis[chassis_of[srv]] += mem
            if not uf_pred:
                mem_nuf_chassis[chassis_of[srv]] += mem
            vm_live[token] = (srv, cores, p95_eff, uf_pred, mem)
            heapq.heappush(departures, (t + life_h, token))
            token += 1

    power = None
    if spec.power is not None and vm_live:
        power = evaluate_power_dynamics(
            vm_live, chassis_of, state.n_chassis, spec.power.budget_w,
            sample_chassis=spec.power.chassis,
            duration_s=spec.power.duration_s, seed=spec.seed,
            backend=spec.power.backend, device=dev)
    return SimMetrics(
        failure_rate=failures / max(placements, 1),
        empty_server_ratio=float(np.mean(empty_samples)),
        chassis_score_std=float(np.mean(chassis_stds)),
        server_score_std=float(np.mean(server_stds)),
        placements=placements, failures=failures, power=power,
        throttled_s=np.zeros(2) if emer is None
        else np.asarray(emer.emg.throttled_by_level(emer.st), np.float64),
        alarms=0 if emer is None else emer.alarms,
        migrations=0 if emer is None else emer.migrations,
        balloon_events=0 if emer is None else emer.balloon_events,
        balloon_reclaimed_gb=0.0 if emer is None
        else emer.balloon_reclaimed_gb,
        ballooned_gb=0.0 if emer is None or emer.bst is None
        else float(np.asarray(emer.bst.ballooned_gb).sum()),
        adaptive_ratio=1.0 if adp is None else adp.ratio,
        adaptive_ratchets=0 if adp is None else adp.ratchets,
        adaptive_backoffs=0 if adp is None else adp.backoffs,
        crit_confusion=crit_cm, p95_confusion=p95_cm)


def fig7_sweep(alphas=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0), days: float = 30.0,
               seed: int = 0, deployments_per_hour: float = 8.0) -> dict:
    """Fig 7: NoRule baseline + {ml, oracle, crit_only} x alpha sweep."""
    def run(pol, mode):
        return simulate(pol, PredictionChannel(mode), SimSpec(
            days=days, seed=seed,
            deployments_per_hour=deployments_per_hour))
    out = {"NoRule": run(SchedulerPolicy(use_power_rule=False), "none")}
    for mode in ("ml", "oracle", "crit_only"):
        for a in alphas:
            pol = SchedulerPolicy(
                alpha=a,
                use_utilization_predictions=(mode != "crit_only"))
            out[f"{mode}:alpha={a}"] = run(pol, mode)
    return out
