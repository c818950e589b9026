"""The resource vector: joint (watts, cores, GB) oversubscription
currency (DESIGN.md §16, docs/resources.md).

The paper oversubscribes *power* only; Coach (arxiv 2501.11179) shows
the larger win comes from oversubscribing cores and memory jointly by
exploiting temporal (diurnal) patterns, and CloudPowerCap (arxiv
1403.1289) argues the power budget must be managed *together with* the
other resources. This module is the shared vocabulary for that: every
admission ceiling, token pool, and per-arrival demand in the serve
plane is an (R,) vector over the axes

    0 = watts  — in rho units (``p95 * cores``), the same currency as
        ``rho_peak``; a watt budget converts through the calibrated
        power model (`serve.admission.rho_cap_from_budget`)
    1 = cores  — allocated virtual cores
    2 = gb     — allocated memory, GB

so the scalar watt protocol of DESIGN.md §10 is exactly the R=1
projection: a disabled axis carries +inf (ceilings/pools) or 0
(demands) and every compare is vacuous on it — decision-bit-identical
to the pre-vector code, which the equivalence tests assert.

`ResourceVector` is the host-side budget/quantity triple (`None` =
axis unbudgeted). Carried over from `repro.core.resources` with its
demand, time-of-day and lift helpers, as numpy (the reference's `xp`
argument is gone: every caller in the port passes host arrays).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: Resource-axis order of every (R,) vector in the serve plane.
RESOURCES = ("watts", "cores", "gb")
N_RESOURCES = len(RESOURCES)
R_WATTS, R_CORES, R_GB = range(N_RESOURCES)


@dataclass(frozen=True)
class ResourceVector:
    """A (watts, cores, GB) triple — budget, capacity, or usage.

    ``None`` means "axis not budgeted" and becomes +inf in ceiling /
    pool form (`as_array`) — the compare against it is vacuous, so a
    power-only `ResourceVector(watts=B)` reproduces the scalar watt
    protocol bit for bit. Frozen and hashable so it can ride in
    jit-static config dataclasses."""
    watts: float | None = None
    cores: float | None = None
    gb: float | None = None

    def as_tuple(self) -> tuple:
        return (self.watts, self.cores, self.gb)

    def as_array(self, fill: float = np.inf) -> np.ndarray:
        """(R,) f64 with `fill` substituted for ``None`` axes."""
        return np.asarray([fill if v is None else float(v)
                           for v in self.as_tuple()], np.float64)

    @property
    def power_only(self) -> bool:
        """True when only the watts axis is budgeted — the scalar
        protocol this vector generalizes."""
        return self.cores is None and self.gb is None

    def scaled(self, ratios) -> "ResourceVector":
        """Per-axis multiply (``None`` axes stay ``None``) — how the
        adaptive controller / diurnal conditioning retargets a
        budget."""
        r = np.asarray(ratios, np.float64)
        vals = [None if v is None else float(v) * float(r[i])
                for i, v in enumerate(self.as_tuple())]
        return ResourceVector(*vals)


def demand_vector(cores, p95_eff, mem_gb):
    """(..., R) per-VM admission draw: ``(p95*cores, cores, gb)``.

    This is the exact quantity `serve.placement.place_batch` adds to the
    chassis ledger — the watts axis is rho units, so axis 0 of the
    ledger IS the legacy ``rho_peak``.
    """
    cores = np.asarray(cores)
    w = np.asarray(p95_eff) * cores
    return np.stack([w, cores, np.asarray(mem_gb)], axis=-1)


def trough_ratios(util, pivot_util: float = 0.55,
                  cores_boost: float = 0.5, gb_boost: float = 0.5):
    """(..., R) Coach-style diurnal conditioning multipliers.

    `util` is the fleet utilization sample (`telemetry.diurnal_util`
    at the current hour on the simulated trace; a measured fleet
    average in production). Relief grows linearly as util falls below
    `pivot_util` (branchless clip):

        relief = clip((pivot - util) / pivot, 0, 1)
        ratios = (1, 1 + cores_boost*relief, 1 + gb_boost*relief)

    Watts never ratchet — a breaker budget is a physical limit; the
    cores/GB axes are statistical commitments that the diurnal trough
    makes temporarily safe to oversell."""
    util = np.asarray(util)
    relief = np.clip((pivot_util - util) / pivot_util, 0.0, 1.0)
    one = np.ones_like(relief)
    return np.stack([one, one + cores_boost * relief,
                     one + gb_boost * relief], axis=-1)


def lift_caps(cap, n_axes: int = N_RESOURCES):
    """Lift a scalar-era (C,) watt-axis ceiling to an (C, R) resource
    ceiling with +inf (vacuous) extra axes; (.., R) passes through, so
    legacy callers keep their exact decisions."""
    cap = np.asarray(cap)
    if cap.ndim >= 2:
        return cap
    pad = np.full(cap.shape + (n_axes - 1,), np.inf, cap.dtype)
    return np.concatenate([cap[..., None], pad], axis=-1)


def lift_pool(pool, n_axes: int = N_RESOURCES):
    """Lift a scalar token-pool balance to (R,) with +inf extra axes;
    (R,) passes through (same compat rule as `lift_caps`)."""
    pool = np.asarray(pool)
    if pool.ndim >= 1:
        return pool
    pad = np.full((n_axes - 1,), np.inf, pool.dtype)
    return np.concatenate([pool[None], pad], axis=-1)
