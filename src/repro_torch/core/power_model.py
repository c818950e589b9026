"""Server/chassis power model calibrated to the paper's measurements.

Paper §IV-A: production blades with 40 cores / 2 sockets draw 112 W idle
and 310 W at 100 % CPU at nominal frequency; 111 W idle and 169 W at
100 % at *half* the nominal frequency.

We model per-core dynamic power as a calibrated mix of linear and cubic
frequency terms (voltage scales with frequency over part of the DVFS
range):

    P(server) = P_idle(f_mean) + sum_c u_c * p_dyn * g(f_c)
    g(f) = a*(f/f_max)^3 + (1-a)*(f/f_max)

Calibration from the paper's 4 measured points gives a ~= 0.552 — i.e.
g(0.5) = 0.293 = (169-111)/(310-112).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F_MAX = 1.0            # nominal ("maximum") core frequency, normalized
F_MIN = 0.5            # minimum p-state = half of maximum (paper §III-D)
N_PSTATES = 11         # f in {0.50, 0.55, ..., 1.00}

P_IDLE_FMAX = 112.0
P_PEAK_FMAX = 310.0
P_IDLE_FMIN = 111.0
P_PEAK_FMIN = 169.0
CORES_PER_SERVER = 40

_DYN_RATIO_HALF = (P_PEAK_FMIN - P_IDLE_FMIN) / (P_PEAK_FMAX - P_IDLE_FMAX)
#: cubic-mix coefficient solving a*0.125 + (1-a)*0.5 = _DYN_RATIO_HALF
CUBIC_MIX = (0.5 - _DYN_RATIO_HALF) / (0.5 - 0.125)


def pstate_frequencies(n: int = N_PSTATES) -> np.ndarray:
    """Available p-state frequencies, descending: f_max .. f_min."""
    return np.linspace(F_MAX, F_MIN, n)


def dyn_scale(f) -> np.ndarray:
    """g(f): dynamic-power multiplier of a core at frequency f (relative
    to f_max). g(1) = 1, g(0.5) ~= 0.293."""
    fr = np.asarray(f, dtype=np.float64) / F_MAX
    return CUBIC_MIX * fr ** 3 + (1.0 - CUBIC_MIX) * fr


def idle_power(f_mean) -> np.ndarray:
    """Idle (static + uncore) power; nearly frequency-flat per the paper
    (112 W @ f_max vs 111 W @ f_max/2)."""
    fr = np.asarray(f_mean, dtype=np.float64) / F_MAX
    return P_IDLE_FMIN + (P_IDLE_FMAX - P_IDLE_FMIN) * (2.0 * fr - 1.0)


@dataclass(frozen=True)
class ServerPowerModel:
    n_cores: int = CORES_PER_SERVER
    p_idle: float = P_IDLE_FMAX
    p_peak: float = P_PEAK_FMAX

    @property
    def p_dyn_per_core(self) -> float:
        return (self.p_peak - self.p_idle) / self.n_cores

    def power(self, util: np.ndarray, freq: np.ndarray) -> np.ndarray:
        """Server power. util/freq: (..., n_cores) per-core utilization
        (0-1) and frequency (F_MIN-F_MAX). Returns (...,) watts."""
        util = np.asarray(util, np.float64)
        freq = np.asarray(freq, np.float64)
        dyn = (util * self.p_dyn_per_core * dyn_scale(freq)).sum(-1)
        return idle_power(freq.mean(-1)) + dyn

    def power_uniform(self, util, freq=F_MAX, active_frac=1.0):
        """Scalar shortcut: all active cores at the same utilization and
        frequency; `active_frac` of cores active, rest idle."""
        util = np.asarray(util, np.float64)
        dyn = (self.n_cores * active_frac * util * self.p_dyn_per_core
               * dyn_scale(freq))
        return idle_power(freq) + dyn

    def reducible_power(self, util, f_from, f_to, n_cores_sub) -> float:
        """Watts shaved by moving `n_cores_sub` cores running at `util`
        from frequency `f_from` down to `f_to` (paper §III-E step 2:
        the power-vs-frequency curve at a given utilization)."""
        per_core = util * self.p_dyn_per_core
        return float(n_cores_sub * per_core
                     * (dyn_scale(f_from) - dyn_scale(f_to)))


def freq_power_curve(model: ServerPowerModel, util: float,
                     n_points: int = N_PSTATES):
    """Paper §III-E step 2: power draw as a function of frequency at a
    fixed average utilization. Returns (freqs, watts) for a full server."""
    freqs = pstate_frequencies(n_points)
    watts = np.array([model.power_uniform(util, f) for f in freqs])
    return freqs, watts
