"""Power-headroom admission control (serve-pipeline stage 4), the
counterpart of `repro.serve.admission`.

The scheduler's aggregates track `rho_peak = sum(p95 * cores)` per
chassis. Under the calibrated server power model a chassis of S blades
drawing its VMs' P95 utilizations at nominal frequency consumes

    P(chassis) = S * P_idle(f_max) + p_dyn_per_core * rho_peak

so a watt budget becomes a ceiling on `rho_peak` that `place_batch`
checks per arrival. The conversions are host numpy, as in the reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.power_model import F_MAX, ServerPowerModel, idle_power
from repro_torch.core.resources import N_RESOURCES, ResourceVector
from repro_torch.serve.placement import DeviceClusterState


def rho_cap_from_budget(budget_w, blades_per_chassis: int,
                        n_chassis: int,
                        model: ServerPowerModel | None = None) -> np.ndarray:
    """(C,) ceiling on per-chassis sum(p95*cores) implied by a chassis
    watt budget. `budget_w`: scalar or (C,); None/inf disables."""
    if budget_w is None:
        return np.full(n_chassis, np.inf, np.float32)
    model = model or ServerPowerModel()
    budget = np.broadcast_to(np.asarray(budget_w, np.float64), (n_chassis,))
    static = blades_per_chassis * float(idle_power(F_MAX))
    cap = (budget - static) / model.p_dyn_per_core
    return np.where(np.isfinite(budget), np.maximum(cap, 0.0),
                    np.inf).astype(np.float32)


def resource_caps_from_budget(budget: ResourceVector,
                              blades_per_chassis: int, n_chassis: int,
                              model: ServerPowerModel | None = None,
                              ratios=None) -> np.ndarray:
    """(C, R) per-chassis admission ceilings from a per-chassis
    `ResourceVector` budget. The watts axis converts through the power
    model like `rho_cap_from_budget`; the cores/GB axes are ledger
    currency already. ``None`` axes disable (+inf column). `ratios`, an
    optional (R,) multiplier, scales the budget first."""
    vec = budget.as_array()
    if ratios is not None:
        vec = vec * np.asarray(ratios, np.float64)
    caps = np.broadcast_to(vec, (n_chassis, N_RESOURCES)).copy()
    caps[:, 0] = rho_cap_from_budget(
        None if budget.watts is None else vec[0], blades_per_chassis,
        n_chassis, model)
    return caps.astype(np.float32)


def projected_chassis_power(state: DeviceClusterState,
                            blades_per_chassis: int,
                            model: ServerPowerModel | None = None) \
        -> np.ndarray:
    """(C,) projected peak draw of each chassis if every placed VM runs
    at its effective P95 at nominal frequency (the admission model)."""
    model = model or ServerPowerModel()
    rho = state.rho_peak.double().cpu().numpy()
    return (blades_per_chassis * float(idle_power(F_MAX))
            + model.p_dyn_per_core * rho).astype(np.float32)


def headroom_w(state: DeviceClusterState, budget_w,
               blades_per_chassis: int,
               model: ServerPowerModel | None = None) -> np.ndarray:
    """(C,) watts of remaining admission headroom (negative when the
    budget is tightened below current commitments; +inf when `budget_w`
    is None)."""
    proj = projected_chassis_power(state, blades_per_chassis, model)
    if budget_w is None:
        return np.full(proj.shape, np.inf, np.float32)
    budget = np.broadcast_to(np.asarray(budget_w, np.float64), proj.shape)
    return (budget - proj).astype(np.float32)
