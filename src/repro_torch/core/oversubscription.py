"""Oversubscription strategy: the 5-step chassis-budget algorithm
(paper §III-E) and the Table IV provisioning scenarios. Host numpy,
carried over from `repro.core.oversubscription` unchanged.

Given acceptable capping-event rates (emax_UF, emax_NUF) and frequency
floors (fmin_UF, fmin_NUF), find the lowest chassis power budget such
that, against the historical draws:

  * every over-budget reading can be shaved back to the budget by
    throttling NUF cores to >= fmin_NUF (counts as an NUF event) or, if
    insufficient, additionally throttling UF cores to >= fmin_UF (counts
    as an event on BOTH types);
  * readings whose required shave exceeds even the UF+NUF reduction make
    the candidate budget infeasible;
  * the UF / NUF event *rates* stay within emax_UF / emax_NUF.

Step 5 adds a buffer (default 10 %) for future variability of beta and
chassis utilization growth.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.power_model import F_MAX, ServerPowerModel
from repro_torch.core.resources import ResourceVector


@dataclass(frozen=True)
class OversubConfig:
    emax_uf: float            # max acceptable UF capping-event rate
    fmin_uf: float            # lowest acceptable UF core frequency
    emax_nuf: float
    fmin_nuf: float
    buffer: float = 0.10      # step-5 budget buffer


#: Table IV scenario parameter sets.
SCENARIOS = {
    "state_of_the_art": OversubConfig(       # full-server, no VM insight:
        emax_uf=0.001, fmin_uf=0.75,         # rare events, light throttle,
        emax_nuf=0.0, fmin_nuf=0.75),        # UF and NUF capped together
    "predictions_no_uf_impact": OversubConfig(
        emax_uf=0.0, fmin_uf=1.00, emax_nuf=0.01, fmin_nuf=0.50),
    "predictions_minimal_uf_impact": OversubConfig(
        emax_uf=0.001, fmin_uf=0.75, emax_nuf=0.009, fmin_nuf=0.50),
}


@dataclass(frozen=True)
class FleetProfile:
    """Step-1 estimates from history + step-2 hardware profile inputs."""
    beta: float               # avg fraction of allocated cores that are UF
    util_uf: float            # avg P95 utilization of UF virtual cores
    util_nuf: float
    allocated_frac: float     # allocated cores / physical cores
    servers_per_chassis: int
    model: ServerPowerModel

    def reduction_capacity(self, fmin_uf: float, fmin_nuf: float):
        """Step 2: attainable chassis power reduction (watts) from
        throttling (a) only NUF cores to fmin_nuf, (b) additionally UF
        cores to fmin_uf — derived from the frequency/power curves at
        the historical average utilizations."""
        n_alloc = (self.model.n_cores * self.servers_per_chassis
                   * self.allocated_frac)
        n_uf = self.beta * n_alloc
        n_nuf = (1.0 - self.beta) * n_alloc
        red_nuf = self.model.reducible_power(
            self.util_nuf, F_MAX, fmin_nuf, n_nuf)
        red_uf = self.model.reducible_power(
            self.util_uf, F_MAX, fmin_uf, n_uf)
        return red_nuf, red_uf


@dataclass
class BudgetResult:
    budget_w: float               # final budget (after buffer)
    budget_pre_buffer_w: float    # step-4 output
    provisioned_w: float
    uf_event_rate: float
    nuf_event_rate: float
    n_draws: int

    @property
    def oversubscription(self) -> float:
        """Fraction of provisioned power recovered ('chassis budget
        delta' in Table IV)."""
        return 1.0 - self.budget_w / self.provisioned_w

    def savings_usd(self, campus_mw: float = 128.0,
                    usd_per_watt: float = 10.0) -> float:
        """Table IV: savings = delta x campus power x $/W."""
        return self.oversubscription * campus_mw * 1e6 * usd_per_watt


def compute_budget(draws_w: np.ndarray, provisioned_w: float,
                   cfg: OversubConfig, fleet: FleetProfile,
                   full_server: bool = False) -> BudgetResult:
    """The 5-step algorithm over historical chassis draws (flattened
    array of one reading per chassis per time unit).

    full_server=True models the state-of-the-art baseline: capping is
    criticality-oblivious, so EVERY capping event throttles UF and NUF
    alike (all cores, same floor), and the attainable reduction is the
    whole fleet's at fmin_uf.
    """
    asc = np.sort(np.asarray(draws_w, np.float64))            # step 3
    n = len(asc)
    d_max = asc[-1]
    red_nuf, red_uf = fleet.reduction_capacity(cfg.fmin_uf, cfg.fmin_nuf)
    red_total = red_nuf + red_uf

    # Step 4, vectorized. Candidate budgets sit just below each distinct
    # draw; every constraint is monotone in the budget (lower budget =>
    # more events, larger max shave), so the feasible set is a prefix of
    # the descending candidate walk and we can evaluate all candidates at
    # once with searchsorted instead of the O(n^2) literal walk.
    distinct = np.unique(asc)[::-1]
    budgets = distinct * (1.0 - 1e-6)         # "just below" each draw
    n_over = n - np.searchsorted(asc, budgets, side="right")
    max_shave = d_max - budgets
    if full_server:
        # one pooled criticality-oblivious mechanism: every event hits UF
        # and NUF alike, so the constraint is on the combined rate
        # (paper: "emax_UF + emax_NUF = 0.1%").
        feasible = max_shave <= red_total
        uf_rate_v = n_over / n
        nuf_rate_v = np.zeros_like(uf_rate_v)
        rate_ok = uf_rate_v <= cfg.emax_uf + cfg.emax_nuf + 1e-12
    else:
        # exclusive counting: an event is a UF event iff UF VMs had to be
        # throttled (shave > red_nuf), else an NUF-only event — so
        # emax_UF + emax_NUF bounds the overall rate (paper scenario #4:
        # 0.1 + 0.9 = 1% overall).
        feasible = max_shave <= red_total
        n_uf = n - np.searchsorted(asc, budgets + red_nuf, side="right")
        uf_rate_v = n_uf / n
        nuf_rate_v = (n_over - n_uf) / n
        rate_ok = ((uf_rate_v <= cfg.emax_uf + 1e-12)
                   & (nuf_rate_v <= cfg.emax_nuf + 1e-12))
    ok = feasible & rate_ok
    # prefix property: stop at the first violation in the descending walk
    first_bad = int(np.argmin(ok)) if not ok.all() else len(ok)
    if first_bad == 0:   # cannot even cap the single highest draw
        best = BudgetResult(provisioned_w, provisioned_w, provisioned_w,
                            0.0, 0.0, n)
    else:
        i = first_bad - 1
        best = BudgetResult(budget_w=float(budgets[i]),
                            budget_pre_buffer_w=float(budgets[i]),
                            provisioned_w=provisioned_w,
                            uf_event_rate=float(uf_rate_v[i]),
                            nuf_event_rate=float(nuf_rate_v[i]),
                            n_draws=n)
    # Step 5: buffer — raise the budget by `buffer` (less aggressive),
    # capped at the provisioned power.
    best.budget_w = min(best.budget_pre_buffer_w * (1.0 + cfg.buffer),
                        provisioned_w)
    return best


def scenario_table(draws_w: np.ndarray, provisioned_w: float,
                   fleet: FleetProfile,
                   beta_internal_only: float | None = None,
                   beta_non_premium: float | None = None) -> dict:
    """Reproduce Table IV's eight provisioning approaches.

    beta_internal_only: the UF core fraction when ALL external VMs are
    treated as user-facing (only internal VMs are classified) — beta
    rises, shrinking the cap-able NUF pool. Similarly beta_non_premium
    treats only premium external VMs as UF.
    """
    rows = {"traditional": BudgetResult(provisioned_w, provisioned_w,
                                        provisioned_w, 0.0, 0.0,
                                        len(np.ravel(draws_w)))}
    d = np.ravel(draws_w)
    rows["state_of_the_art"] = compute_budget(
        d, provisioned_w, SCENARIOS["state_of_the_art"], fleet,
        full_server=True)
    rows["predictions_all_no_uf_impact"] = compute_budget(
        d, provisioned_w, SCENARIOS["predictions_no_uf_impact"], fleet)
    rows["predictions_all_minimal_uf_impact"] = compute_budget(
        d, provisioned_w, SCENARIOS["predictions_minimal_uf_impact"],
        fleet)
    for name, beta in (("internal", beta_internal_only),
                       ("internal_non_premium", beta_non_premium)):
        if beta is None:
            continue
        f2 = FleetProfile(beta=beta, util_uf=fleet.util_uf,
                          util_nuf=fleet.util_nuf,
                          allocated_frac=fleet.allocated_frac,
                          servers_per_chassis=fleet.servers_per_chassis,
                          model=fleet.model)
        rows[f"predictions_{name}_no_uf_impact"] = compute_budget(
            d, provisioned_w, SCENARIOS["predictions_no_uf_impact"], f2)
        rows[f"predictions_{name}_minimal_uf_impact"] = compute_budget(
            d, provisioned_w, SCENARIOS["predictions_minimal_uf_impact"],
            f2)
    return rows


def joint_chassis_budget(draws_w: np.ndarray, provisioned_w: float,
                         cfg: OversubConfig, fleet: FleetProfile,
                         cores_per_chassis: float,
                         gb_per_chassis: float,
                         core_ratio: float = 1.0,
                         gb_ratio: float = 1.0,
                         full_server: bool = False
                         ) -> tuple[BudgetResult, ResourceVector]:
    """Joint (watts, cores, GB) chassis budget (DESIGN.md §16).

    The watts axis comes from the paper's 5-step algorithm
    (`compute_budget`); the cores/GB axes are Coach-style
    oversubscription ratios over the *physical* chassis capacity
    (``ratio >= 1`` oversells the axis; the serve plane's per-resource
    admission ledger enforces the result, and `resources.trough_ratios`
    conditions the ratios on the diurnal trough at admission time).
    Returns ``(BudgetResult, ResourceVector)`` — the vector is what
    `serve.admission.resource_caps_from_budget` turns into per-chassis
    (C, R) ceilings."""
    result = compute_budget(draws_w, provisioned_w, cfg, fleet,
                            full_server=full_server)
    vec = ResourceVector(watts=result.budget_w,
                         cores=core_ratio * float(cores_per_chassis),
                         gb=gb_ratio * float(gb_per_chassis))
    return result, vec
