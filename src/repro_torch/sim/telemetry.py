"""Synthetic VM workload population with ground truth.

Azure's April-2019 VM workload and its 840 manually-labeled series are
private; this generator is the documented substitution (DESIGN.md §7).
It reproduces the *structure* the paper describes:

  * user-facing diurnal workloads with (paper §III-B issues 1-2) noise,
    interruptions, growth/decay trends, and day-to-day peak variation;
  * machine-generated workloads with 1h/4h/6h/8h/12h periods (issue 3 —
    all divide 24h, which fools FFT/ACF);
  * non-user-facing batch/dev-test workloads (constant, random-walk,
    bursty);
  * subscription-level correlation: VMs arrive from subscriptions whose
    historical mix is predictive (this is what the paper's ML models
    exploit: their top features are subscription aggregates).

Everything is numpy (host-side data plane), carried over unchanged from
`repro.sim.telemetry` so that the same seed gives the same population; the
algorithms that run on the card are torch. Only the population generator
and the arrival wire format are carried; the stream and merge helpers
belong to later parts of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SLOTS_PER_DAY = 48
DAYS = 5
T = SLOTS_PER_DAY * DAYS

VM_TYPES = ("web", "db", "api", "batch", "dev", "ci", "agent")
UF_CLASS_NAMES = ("uf_diurnal", "uf_noisy", "machine_periodic", "batch_flat",
                  "batch_random", "dev_burst")
UF_TRUTH = {"uf_diurnal": True, "uf_noisy": True, "machine_periodic": False,
            "batch_flat": False, "batch_random": False, "dev_burst": False}


@dataclass
class VMRecord:
    """One VM with its ground truth and arrival-time metadata."""
    vm_id: int
    subscription: int
    klass: str                 # generator class name (ground truth source)
    user_facing: bool          # ground-truth label
    cores: int
    memory_gb: int
    vm_type: str
    lifetime_hours: float
    avg_util: float            # realized average CPU utilization (0-100)
    p95_util: float            # realized P95 CPU utilization (0-100)
    series: np.ndarray         # (T,) 30-min average utilization


def _diurnal(rng, noisy: bool) -> np.ndarray:
    slots = np.arange(T)
    tod = (slots % SLOTS_PER_DAY) / SLOTS_PER_DAY
    phase = rng.uniform(0, 0.3)
    # business-hours hump + secondary evening bump
    base = (np.clip(np.sin((tod - 0.25 - phase) * 2 * np.pi), 0, None) ** 1.5
            + 0.35 * np.clip(np.sin((tod - 0.7 - phase) * 2 * np.pi), 0, None))
    peak = rng.uniform(35, 90)
    floor = rng.uniform(2, 15)
    # per-day peak magnitude variation (paper issue #2)
    day_scale = 1.0 + rng.uniform(-0.35, 0.35, DAYS).repeat(SLOTS_PER_DAY)
    # multiplicative growth/decay trend (paper issue #2)
    trend = np.exp(rng.uniform(-0.12, 0.18) * slots / SLOTS_PER_DAY)
    x = floor + peak * base * day_scale * trend
    noise_sd = rng.uniform(1.0, 3.0) if not noisy else rng.uniform(5.0, 10.0)
    x = x + rng.normal(0, noise_sd, T)
    if noisy:
        # day-to-day phase jitter (+-30 min): users shift their day;
        # lag-based autocorrelation decorrelates, 30-min median
        # templates barely move (paper issues #1/#2 combined)
        for d in range(DAYS):
            shift = int(rng.integers(-1, 2))
            seg = x[d * SLOTS_PER_DAY:(d + 1) * SLOTS_PER_DAY]
            x[d * SLOTS_PER_DAY:(d + 1) * SLOTS_PER_DAY] = \
                np.roll(seg, shift)
        # interruption: up to a day of constant or random load (issue #1)
        w = int(rng.integers(SLOTS_PER_DAY // 2, SLOTS_PER_DAY))
        s = int(rng.integers(0, T - w))
        if rng.random() < 0.5:
            x[s:s + w] = rng.uniform(5, 60)
        else:
            x[s:s + w] = rng.uniform(5, 60, w)
    return x


def _machine_periodic(rng) -> np.ndarray:
    # Mostly divisors of 8h (hourly crons, 4h syncs, ...). 6h/12h periods
    # do NOT divide 8h, so Compare8 conservatively labels them user-facing
    # (the paper accepts this direction of error); keep them a small tail.
    period_hours = rng.choice([1, 2, 4, 8, 6, 12],
                              p=[0.3, 0.25, 0.25, 0.1, 0.05, 0.05])
    period = int(period_hours * 2)           # slots
    slots = np.arange(T)
    duty = rng.uniform(0.1, 0.5)
    spike = ((slots % period) < max(1, int(duty * period))).astype(float)
    lo = rng.uniform(2, 10)
    hi = rng.uniform(40, 95)
    x = lo + (hi - lo) * spike + rng.normal(0, 1.5, T)
    return x


def _batch_flat(rng) -> np.ndarray:
    level = rng.uniform(20, 95)
    return level + rng.normal(0, rng.uniform(0.5, 4.0), T)


def _batch_random(rng) -> np.ndarray:
    # random-walk load (data-dependent batch stages)
    steps = rng.normal(0, 6.0, T)
    x = 40 + np.cumsum(steps)
    x = 40 + (x - 40) * 0.9 ** (np.arange(T) / 24)  # mean-revert slowly
    return x + rng.normal(0, 2.0, T)


def _dev_burst(rng) -> np.ndarray:
    # idle with sporadic bursts (development / testing)
    x = rng.uniform(1, 6) + rng.normal(0, 1.0, T)
    n_bursts = rng.integers(3, 12)
    for _ in range(n_bursts):
        s = rng.integers(0, T - 4)
        w = rng.integers(2, 8)
        x[s:s + w] += rng.uniform(30, 90)
    return x


_GEN = {"uf_diurnal": lambda rng: _diurnal(rng, False),
        "uf_noisy": lambda rng: _diurnal(rng, True),
        "machine_periodic": _machine_periodic,
        "batch_flat": _batch_flat,
        "batch_random": _batch_random,
        "dev_burst": _dev_burst}

#: Paper Table I distributions.
CORE_SIZES = np.array([1, 2, 4, 8, 16, 24, 32])
CORE_PROBS = np.array([0.33, 0.27, 0.21, 0.10, 0.05, 0.03, 0.01])
LIFETIME_BUCKETS = [(1, 1), (2, 2), (3, 5), (6, 10), (10, 25), (26, 720),
                    (721, 2160)]
LIFETIME_PROBS = np.array([0.52, 0.05, 0.10, 0.09, 0.07, 0.08, 0.09])
DEPLOY_SIZE_BUCKETS = [(1, 1), (2, 2), (3, 5), (6, 10), (11, 15), (16, 25),
                       (26, 60)]
DEPLOY_SIZE_PROBS = np.array([0.39, 0.14, 0.16, 0.09, 0.08, 0.05, 0.09])

_UF_TYPES = ("web", "db", "api")
_NUF_TYPES = ("batch", "dev", "ci", "agent")


def _sample_bucket(rng, buckets, probs):
    i = rng.choice(len(buckets), p=probs)
    lo, hi = buckets[i]
    return float(rng.integers(lo, hi + 1))


@dataclass
class Population:
    vms: list = field(default_factory=list)

    @property
    def series(self) -> np.ndarray:
        return np.stack([v.series for v in self.vms])

    @property
    def labels(self) -> np.ndarray:
        return np.array([v.user_facing for v in self.vms])

    def classes(self) -> np.ndarray:
        return np.array([v.klass for v in self.vms])


def generate_population(n_vms: int, seed: int = 0,
                        uf_fraction: float = 0.45,
                        n_subscriptions: int | None = None) -> Population:
    """Generate a labeled VM population.

    Subscriptions are sampled with a per-subscription UF propensity so
    subscription aggregates carry signal (paper §IV-B: the top model
    features are subscription-level percentages).
    """
    rng = np.random.default_rng(seed)
    if n_subscriptions is None:
        n_subscriptions = max(8, n_vms // 24)
    # Strongly bimodal: most subscriptions are near-single-purpose (all
    # interactive services or all batch), which is why the paper's top
    # criticality feature — subscription %-user-facing — is so predictive.
    sub_propensity = rng.beta(0.35, 0.35, n_subscriptions)
    sub_propensity = uf_fraction * sub_propensity / sub_propensity.mean()
    sub_propensity = np.clip(sub_propensity, 0.02, 0.98)
    # Per-subscription utilization scale: subscriptions run consistently
    # hot or cold fleets. This is the signal behind the paper's top P95
    # features (subscription avg-of-P95 / avg-of-avg utilizations), and
    # makes bucket-1/bucket-4 the most popular buckets as in Table III.
    sub_util_scale = 0.10 + 1.15 * rng.beta(0.40, 0.40, n_subscriptions)

    pop = Population()
    for vm_id in range(n_vms):
        sub = int(rng.integers(0, n_subscriptions))
        is_uf = rng.random() < sub_propensity[sub]
        if is_uf:
            klass = rng.choice(["uf_diurnal", "uf_noisy"], p=[0.7, 0.3])
            vm_type = rng.choice(_UF_TYPES)
        else:
            klass = rng.choice(
                ["machine_periodic", "batch_flat", "batch_random",
                 "dev_burst"], p=[0.3, 0.25, 0.25, 0.2])
            vm_type = rng.choice(_NUF_TYPES)
        amp = sub_util_scale[sub] * rng.uniform(0.88, 1.12)
        series = np.clip(_GEN[klass](rng) * amp, 0.0, 100.0)
        cores = int(rng.choice(CORE_SIZES, p=CORE_PROBS))
        pop.vms.append(VMRecord(
            vm_id=vm_id, subscription=sub, klass=klass,
            user_facing=UF_TRUTH[klass], cores=cores,
            memory_gb=int(cores * rng.choice([2, 4, 8])),
            vm_type=vm_type,
            lifetime_hours=_sample_bucket(rng, LIFETIME_BUCKETS,
                                          LIFETIME_PROBS),
            avg_util=float(series.mean()),
            p95_util=float(np.percentile(series, 95)),
            series=series.astype(np.float32)))
    return pop


# --- streaming arrivals (serve-pipeline ingest format) --------------------

VM_TYPE_IDX = {t: i for i, t in enumerate(VM_TYPES)}


@dataclass
class ArrivalBatch:
    """Struct-of-arrays view of a slice of arriving VMs — the wire
    format of the online serving pipeline (`repro_torch.serve`). Ground-truth
    columns ride along for evaluation; the pipeline never reads them."""
    subscription: np.ndarray        # (B,) int32
    cores: np.ndarray               # (B,) float32
    memory_gb: np.ndarray           # (B,) float32
    vm_type_idx: np.ndarray         # (B,) int32
    user_facing: np.ndarray         # (B,) bool — ground truth
    p95_util: np.ndarray            # (B,) float32 (0-100) — ground truth
    lifetime_hours: np.ndarray      # (B,) float32 — ground truth

    def __len__(self) -> int:
        return len(self.subscription)


def arrival_batch(pop: Population, idx=None) -> ArrivalBatch:
    """Pack (a slice of) a population into one ArrivalBatch."""
    vms = pop.vms if idx is None else [pop.vms[i] for i in np.atleast_1d(idx)]
    return ArrivalBatch(
        subscription=np.array([v.subscription for v in vms], np.int32),
        cores=np.array([v.cores for v in vms], np.float32),
        memory_gb=np.array([v.memory_gb for v in vms], np.float32),
        vm_type_idx=np.array([VM_TYPE_IDX[v.vm_type] for v in vms],
                             np.int32),
        user_facing=np.array([v.user_facing for v in vms], bool),
        p95_util=np.array([v.p95_util for v in vms], np.float32),
        lifetime_hours=np.array([v.lifetime_hours for v in vms],
                                np.float32))
