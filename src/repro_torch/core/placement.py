"""Criticality- & utilization-aware VM placement (paper Algorithm 1).

`score_candidates` is the paper's SortCandidates preference rule,
vectorized with numpy over candidate servers (the production scheduler
scores thousands of candidates in ~7 ms; here one vectorized pass).
Carried over from `repro.core.placement` as the oracle that
`repro_torch.serve.placement` is held against.

Note on the paper's pseudo-code: lines 20/22 of Algorithm 1 are garbled
in the text ("(1 + γNUF/MCC)"), but §IV-E states the server score
explicitly: (1/2) * (1 + (γ^NUF - γ^UF) / N^cores) for a user-facing VM,
with the difference reversed for a non-user-facing VM. We implement that.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

ALPHA_DEFAULT = 0.8     # §IV-E: alpha=0.8 strikes the best compromise


@dataclass
class ClusterState:
    """Aggregate per-server / per-chassis state the rule needs.

    Incrementally maintained so scoring is O(candidates), matching the
    production constraint (7 ms budget).
    """
    n_servers: int
    cores_per_server: int
    chassis_of_server: np.ndarray          # (n_servers,) int
    n_chassis: int
    free_cores: np.ndarray = field(default=None)       # (n_servers,)
    gamma_uf: np.ndarray = field(default=None)         # (n_servers,) sum p95*cores, UF VMs
    gamma_nuf: np.ndarray = field(default=None)        # (n_servers,)
    rho_peak: np.ndarray = field(default=None)         # (n_chassis,) sum p95*cores
    rho_max: np.ndarray = field(default=None)          # (n_chassis,) total cores*1.0

    def __post_init__(self):
        if self.free_cores is None:
            self.free_cores = np.full(self.n_servers, self.cores_per_server,
                                      dtype=np.float64)
        if self.gamma_uf is None:
            self.gamma_uf = np.zeros(self.n_servers)
        if self.gamma_nuf is None:
            self.gamma_nuf = np.zeros(self.n_servers)
        if self.rho_peak is None:
            self.rho_peak = np.zeros(self.n_chassis)
        if self.rho_max is None:
            self.rho_max = np.zeros(self.n_chassis)
            np.add.at(self.rho_max, self.chassis_of_server,
                      float(self.cores_per_server))

    def place(self, server: int, cores: int, p95: float, is_uf: bool):
        assert self.free_cores[server] >= cores, "constraint rule violated"
        self.free_cores[server] -= cores
        w = p95 * cores
        if is_uf:
            self.gamma_uf[server] += w
        else:
            self.gamma_nuf[server] += w
        self.rho_peak[self.chassis_of_server[server]] += w

    def remove(self, server: int, cores: int, p95: float, is_uf: bool):
        self.free_cores[server] += cores
        w = p95 * cores
        if is_uf:
            self.gamma_uf[server] -= w
        else:
            self.gamma_nuf[server] -= w
        self.rho_peak[self.chassis_of_server[server]] -= w

    # -- Algorithm 1 ------------------------------------------------------
    def score_chassis(self) -> np.ndarray:
        """ScoreChassis for every chassis: 1 - rho_peak/rho_max."""
        return 1.0 - self.rho_peak / np.maximum(self.rho_max, 1e-9)

    def score_server(self, vm_is_uf: bool) -> np.ndarray:
        """ScoreServer for every server given the arriving VM's type."""
        n_cores = float(self.cores_per_server)
        diff = (self.gamma_nuf - self.gamma_uf) if vm_is_uf else \
            (self.gamma_uf - self.gamma_nuf)
        return 0.5 * (1.0 + diff / n_cores)

    def score_candidates(self, vm_is_uf: bool, candidates: np.ndarray,
                         alpha: float = ALPHA_DEFAULT) -> np.ndarray:
        """SortCandidates: score for each candidate server index.
        Higher is better; caller sorts descending."""
        kappa = self.score_chassis()[self.chassis_of_server[candidates]]
        eta = self.score_server(vm_is_uf)[candidates]
        return alpha * kappa + (1.0 - alpha) * eta

    def feasible(self, cores: int) -> np.ndarray:
        """Constraint rule: servers with enough free cores."""
        return np.nonzero(self.free_cores >= cores)[0]


def packing_score(state: ClusterState, candidates: np.ndarray) -> np.ndarray:
    """The existing scheduler's packing preference (best-fit): prefer the
    server with the fewest free cores that still fits. Normalized to
    [0, 1], higher = fuller = better packing."""
    return 1.0 - state.free_cores[candidates] / state.cores_per_server


@dataclass(frozen=True)
class SchedulerPolicy:
    """Azure-style rule aggregation (§II-C): each preference rule orders
    candidates; each candidate is weighted by its (normalized, inverted)
    rank under each rule times the rule weight; highest aggregate wins.

    use_power_rule=False reproduces the 'NoRule' baseline of Fig. 7.
    """
    alpha: float = ALPHA_DEFAULT
    use_power_rule: bool = True
    use_utilization_predictions: bool = True   # Fig 7 orange bar: False
    packing_weight: float = 1.0
    power_weight: float = 2.0

    def effective_p95(self, p95_pred: float) -> float:
        """The p95 value recorded into cluster aggregates at placement:
        the prediction, or conservative 100 % when utilization
        predictions are disabled (Fig 7 orange bars)."""
        return p95_pred if self.use_utilization_predictions else 1.0

    def choose(self, state: ClusterState, cores: int, vm_is_uf: bool):
        cands = state.feasible(cores)
        if len(cands) == 0:
            return None                         # deployment failure
        ranks = np.zeros(len(cands))
        pack = packing_score(state, cands)
        ranks += self.packing_weight * _rank_weight(pack)
        if self.use_power_rule:
            power = state.score_candidates(vm_is_uf, cands, self.alpha)
            ranks += self.power_weight * _rank_weight(power)
        return int(cands[int(np.argmax(ranks))])


def _rank_weight(scores: np.ndarray) -> np.ndarray:
    """Order-based weight: best candidate gets 1.0, worst gets ~0
    (ties share by stable ranking)."""
    n = len(scores)
    if n == 1:
        return np.ones(1)
    order = np.argsort(np.argsort(-scores, kind="stable"), kind="stable")
    return 1.0 - order / (n - 1)
