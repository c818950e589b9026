"""Online power-emergency control plane, the counterpart of
`repro.serve.emergency`.

The serve pipeline admits against *projected* peak draw
(`serve.admission`); an emergency is a chassis whose measured draw trips
the protective-capping alarm, and watts must come off now with the
least impact on critical workloads (the paper's headline property):

  * **Alarms** — every chassis is polled in one compare against
    ``alert_fraction * chassis_budget_w`` (`EmergencyConfig.alert_w`).
  * **Criticality-aware apportionment** — the required cut (sampled draw
    minus the capped target) is apportioned across criticality levels
    lowest-first by `core.capping.apportion_watts`: non-critical dynamic
    draw is shaved to its frequency floor before critical VMs lose a
    hertz, critical levels are capped to their (higher) floor next, and
    only a cut no floor can absorb engages the RAPL backstop (all cores
    to f_min). The plane knows each level's committed dynamic draw from
    the placement aggregates, so the post-action draw lands at or under
    the target in the same step that raised the alarm.
  * **Hysteresis** — a chassis whose draw falls back below the alert
    threshold holds its cap for `lift_after_s`, then restores nominal
    frequency.
  * **Dwell** — `capped_s` tracks how long each chassis has been capped;
    `mitigation_due` flags chassis whose critical level has been
    throttled past `dwell_s`, the signal `serve.mitigation` turns into
    a migration plan.

Every function exists twice. The `*_np` functions are the numpy oracle,
array-equal to the reference's numpy call. The others are the torch twin:
the same operations in the same order, in the state's dtype and on its
device, bit-equal to the oracle in float64. Scalars enter the twin
already rounded to its dtype (`_scalar`), and the only divisions divide
by tensors. `chassis_rho_levels` adds the blade columns in numpy's
pairwise order (`_numpy_order_sum`), so the card, the CPU and the oracle
agree on the aggregates bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.capping import (ChassisManager, RaplController,
                                      apportion_watts, apportion_watts_torch)
from repro_torch.core.fleet_dynamics import (ALERT_FRACTION, ALERT_MARGIN_W,
                                             FREQ_TABLE, LIFT_AFTER_S)
from repro_torch.core.power_model import (F_MAX, N_PSTATES, ServerPowerModel,
                                          dyn_scale, idle_power)
from repro_torch.device import resolve_device

#: Criticality levels, in apportionment priority order: level 0
#: (non-user-facing) absorbs the cut first, level 1 (user-facing /
#: critical) only when level 0's floor is insufficient.
CRIT_NUF = 0
CRIT_UF = 1
N_LEVELS = 2

#: Default frequency floor of the *critical* level: p-state 5 = 0.75
#: f_max — critical VMs may be trimmed this far by the criticality-aware
#: stage; anything deeper takes the RAPL backstop.
UF_FLOOR_PSTATE = 5

_TOL_W = 1e-6          # leftover below this is float fuzz, not a deficit


@dataclass(frozen=True)
class EmergencyConfig:
    """Static (hashable) knobs of the power-emergency plane.

    `floors` is the per-criticality-level p-state floor in priority
    order: how deep the criticality-aware stage may cap each level
    before the leftover falls through to the RAPL backstop. The default
    lets non-critical VMs reach f_min while critical VMs are never
    trimmed below 0.75 f_max without RAPL."""
    chassis_budget_w: float
    alert_fraction: float = ALERT_FRACTION
    target_margin_w: float = ALERT_MARGIN_W
    floors: tuple = (N_PSTATES - 1, UF_FLOOR_PSTATE)
    lift_after_s: float = LIFT_AFTER_S
    dwell_s: float = 30.0
    criticality_blind: bool = False
    blades_per_chassis: int = 12
    p_dyn_per_core: float = ServerPowerModel().p_dyn_per_core
    idle_w_per_server: float = float(idle_power(F_MAX))

    @property
    def alert_w(self) -> float:
        """Protective-capping alarm threshold (watts)."""
        return self.chassis_budget_w * self.alert_fraction

    @property
    def target_w(self) -> float:
        """Draw the apportionment steers an alarmed chassis to."""
        return self.chassis_budget_w - self.target_margin_w

    @property
    def static_w(self) -> float:
        """Frequency-independent chassis floor: every blade's idle draw
        at nominal frequency (the admission model's intercept)."""
        return self.blades_per_chassis * self.idle_w_per_server

    def manager(self) -> ChassisManager:
        """The equivalent per-chassis `core.capping.ChassisManager`."""
        return ChassisManager(self.chassis_budget_w, self.alert_fraction,
                              self.target_margin_w)

    @classmethod
    def from_model(cls, chassis_budget_w: float,
                   model: ServerPowerModel | None = None,
                   **kw) -> "EmergencyConfig":
        """Build a config calibrated to a `ServerPowerModel`."""
        model = model or ServerPowerModel()
        return cls(chassis_budget_w=chassis_budget_w,
                   p_dyn_per_core=model.p_dyn_per_core, **kw)


class EmergencyState(NamedTuple):
    """Per-chassis controller state; fixed-shape, with optional leading
    batch dims. numpy arrays for the oracle, tensors for the twin."""
    pstate: Any        # (..., C, L) int32 — per-level uniform p-state
    rapl: Any          # (..., C) bool — RAPL backstop engaged
    capped_s: Any      # (..., C) — continuous seconds capped (dwell)
    clear_s: Any       # (..., C) — seconds since the alarm cleared
    throttled_s: Any   # (..., C, L) — cumulative per-level
    last_t: Any        # (..., C) — stamp of the last applied sample


class EmergencyOutputs(NamedTuple):
    """Per-sample observables of one emergency step."""
    power_w: Any       # (..., C) — offered (uncapped) draw this sample
    power_after_w: Any  # (..., C) — draw at the post-action settings
    alarm: Any         # (..., C) bool
    cut_w: Any         # (..., C) — required reduction past the target
    leftover_w: Any    # (..., C) — cut no floor absorbed (RAPL trigger)
    cut_by_level_w: Any  # (..., C, L) — watts removed per crit level


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _scalar(x: float, dtype: torch.dtype) -> float:
    """`x` rounded to `dtype` (as numpy's ``dtype.type(x)``), handed back
    as a Python float that the twin's ops take exactly."""
    return float(_NP_DTYPE[dtype](x))


def _gtab_np(dtype) -> np.ndarray:
    return np.asarray(dyn_scale(FREQ_TABLE), dtype)


# --- numpy oracle ---------------------------------------------------------

def init_emergency_np(n_chassis: int, batch_shape=(),
                      dtype=np.float32) -> EmergencyState:
    """Uncapped initial state — nominal frequency everywhere, no alarm
    ever seen (``last_t = -inf``)."""
    shape_c = tuple(batch_shape) + (n_chassis,)
    shape_l = shape_c + (N_LEVELS,)
    return EmergencyState(
        pstate=np.zeros(shape_l, np.int32),
        rapl=np.zeros(shape_c, bool),
        capped_s=np.zeros(shape_c, dtype),
        clear_s=np.full(shape_c, np.inf, dtype),
        throttled_s=np.zeros(shape_l, dtype),
        last_t=np.full(shape_c, -np.inf, dtype))


def chassis_rho_levels_np(gamma_nuf, gamma_uf, chassis_servers):
    """(C, L) committed ``sum(p95*cores)`` per chassis per criticality
    level, gathered from the per-server aggregates through the (C, K)
    chassis->servers table (non-critical level first)."""
    gamma_nuf, gamma_uf = np.asarray(gamma_nuf), np.asarray(gamma_uf)
    nuf = np.sum(gamma_nuf[chassis_servers], axis=-1)
    uf = np.sum(gamma_uf[chassis_servers], axis=-1)
    return np.stack([nuf, uf], axis=-1)


def sampled_power_np(cfg: EmergencyConfig, rho_lv, util, pstate, rapl):
    """Chassis draw at the given control settings under the admission
    power model: ``static + p_dyn * sum_l rho_l * util * g(f_l)``, with
    RAPL-engaged chassis at f_min on every level."""
    dtype = np.asarray(rho_lv).dtype
    gtab = _gtab_np(dtype)
    g = np.where(np.asarray(rapl)[..., None],
                 gtab[RaplController.backstop_pstate()], gtab[pstate])
    util = np.asarray(util, dtype)
    dyn = cfg.p_dyn_per_core * rho_lv * util[..., None]
    return cfg.static_w + np.sum(dyn * g, axis=-1)


def util_from_power_np(cfg: EmergencyConfig, rho_lv, power_w):
    """Implied utilization of the committed P95 behind a sampled uncapped
    draw: ``(power - static) / (p_dyn * sum_l rho_l)``, clipped at 0,
    and 0 for a chassis with nothing committed."""
    rho = np.sum(rho_lv, axis=-1)
    dyn = np.maximum(np.asarray(power_w) - cfg.static_w, 0)
    return np.where(rho > 0,
                    dyn / (cfg.p_dyn_per_core * np.where(rho > 0, rho, 1)),
                    0.0)


def emergency_step_np(cfg: EmergencyConfig, st: EmergencyState, rho_lv,
                      util, t):
    """One emergency step over a (batch of) chassis.

    rho_lv: (..., C, L) committed p95*cores per level; util: scalar or
    (..., C) utilization sample scaling the commitment into an offered
    draw; `t`: sample stamp (scalar or (..., C)) — the time since
    `last_t` accrues the dwell clock and the per-level throttled-seconds
    at the settings that held over the interval.

    Returns ``(new_state, EmergencyOutputs)``."""
    rho_lv = np.asarray(rho_lv)
    dtype = rho_lv.dtype
    util = np.asarray(util, dtype)
    dyn_full = cfg.p_dyn_per_core * rho_lv * util[..., None]
    p_full = cfg.static_w + np.sum(dyn_full, axis=-1)     # (..., C)
    alarm = p_full >= dtype.type(cfg.alert_w)

    t = np.asarray(t, st.last_t.dtype)
    dt = np.where(np.isfinite(st.last_t),
                  np.maximum(t - st.last_t, 0), 0).astype(dtype)

    # accrue dwell + throttled-seconds at the settings that held over
    # [last_t, t)
    was_thr = (st.pstate > 0) | st.rapl[..., None]        # (..., C, L)
    throttled_s = st.throttled_s + dt[..., None] * was_thr
    was_capped = np.any(was_thr, axis=-1)
    capped_accum = (st.capped_s + dt) * was_capped
    clear_accum = np.where(alarm, 0,
                           np.where(was_capped, st.clear_s + dt,
                                    dtype.type(np.inf)))
    lift = was_capped & ~alarm \
        & (clear_accum >= dtype.type(cfg.lift_after_s))
    hold = was_capped & ~alarm & ~lift

    cut = np.maximum(p_full - dtype.type(cfg.target_w), 0)
    pst_new, _, leftover = apportion_watts(
        cut, dyn_full, cfg.floors, blind=cfg.criticality_blind)
    pstate = np.where(alarm[..., None], pst_new,
                      np.where(hold[..., None], st.pstate, 0))
    rapl = np.where(alarm, leftover > _TOL_W,
                    np.where(hold, st.rapl, False))

    now_capped = np.any(pstate > 0, axis=-1) | rapl
    capped_s = np.where(now_capped, capped_accum, 0).astype(dtype)
    clear_s = np.where(alarm, 0,
                       np.where(now_capped, clear_accum,
                                dtype.type(np.inf))).astype(dtype)
    last_t = np.broadcast_to(t, st.last_t.shape).astype(st.last_t.dtype)

    p_after = sampled_power_np(cfg, rho_lv, util, pstate, rapl)
    # per-level watts removed at the post-action settings — the same g as
    # `sampled_power_np`, so cut_by_level decomposes p_full - p_after
    gtab = _gtab_np(dtype)
    g = np.where(rapl[..., None],
                 gtab[RaplController.backstop_pstate()], gtab[pstate])
    cut_lv = dyn_full * (1 - g)
    st2 = EmergencyState(pstate, rapl, capped_s, clear_s,
                         throttled_s.astype(dtype), last_t)
    return st2, EmergencyOutputs(p_full, p_after, alarm, cut, leftover,
                                 cut_lv)


def masked_step_np(cfg: EmergencyConfig, st: EmergencyState, rho_lv,
                   power_w, mask, t):
    """`emergency_step_np` driven by sampled draws for a subset of
    chassis. power_w/mask/t: (..., C) — only ``mask`` rows carry a fresh
    sample (their utilization is implied by `util_from_power_np`);
    unmasked chassis carry their state forward untouched, clocks
    included."""
    util = util_from_power_np(cfg, rho_lv, power_w)
    st2, out = emergency_step_np(cfg, st, rho_lv, util, t)

    def sel(new, old):
        m = mask[..., None] if new.ndim == mask.ndim + 1 else mask
        return np.where(m, new, old)

    st3 = EmergencyState(*(sel(n, np.asarray(o)) for n, o in zip(st2, st)))
    zero = np.zeros_like(out.power_w)
    return st3, EmergencyOutputs(
        np.where(mask, out.power_w, zero),
        np.where(mask, out.power_after_w, zero),
        mask & out.alarm,
        np.where(mask, out.cut_w, zero),
        np.where(mask, out.leftover_w, zero),
        np.where(mask[..., None], out.cut_by_level_w, zero[..., None]))


def scatter_samples_np(n_chassis: int, chassis, power_w, t,
                       dtype=np.float32):
    """Densify one sparse sample batch: (B,) chassis ids (unique — the
    pipeline splits duplicate-bearing windows) with their draws and
    stamps become the (C,) ``(power_w, mask, t)`` operands of
    `masked_step_np` (stamps in float64)."""
    chassis = np.asarray(chassis, np.int64)
    pw = np.zeros(n_chassis, dtype)
    mask = np.zeros(n_chassis, bool)
    ts = np.zeros(n_chassis, np.float64)
    pw[chassis] = power_w
    mask[chassis] = True
    ts[chassis] = t
    return pw, mask, ts


def mitigation_due_np(cfg: EmergencyConfig, st: EmergencyState):
    """(..., C) bool — chassis whose cap has dwelled past ``cfg.dwell_s``
    with the critical level throttled (a polite NUF cap never migrates
    anyone): the trigger `serve.mitigation.plan_migrations` consumes."""
    crit_thr = (st.pstate[..., CRIT_UF] > 0) | st.rapl
    return crit_thr & (st.capped_s >= cfg.dwell_s)


def reset_dwell_np(st: EmergencyState, chassis_mask) -> EmergencyState:
    """Zero the dwell clock of the masked chassis — called after a
    migration plan is emitted for them, so one persistent emergency
    yields one plan per dwell period, not one per sample."""
    return st._replace(capped_s=np.where(chassis_mask, 0, st.capped_s))


def throttled_by_level(st: EmergencyState) -> np.ndarray:
    """(L,) total throttled-seconds per criticality level, summed over
    chassis (and any leading batch dims) on the host, for either form of
    the state. Index `CRIT_UF` is the critical number criticality-aware
    apportionment keeps low."""
    thr = st.throttled_s
    if torch.is_tensor(thr):
        thr = thr.cpu().numpy()
    return np.asarray(thr).reshape(-1, N_LEVELS).sum(0)


# --- torch twin -----------------------------------------------------------

def init_emergency(n_chassis: int, batch_shape=(), dtype=torch.float32,
                   device=None) -> EmergencyState:
    """`init_emergency_np` as tensors on `device` (None: the card,
    raising without one; pipelines pass their state's device)."""
    device = resolve_device(device)
    shape_c = tuple(batch_shape) + (n_chassis,)
    shape_l = shape_c + (N_LEVELS,)
    return EmergencyState(
        pstate=torch.zeros(shape_l, dtype=torch.int32, device=device),
        rapl=torch.zeros(shape_c, dtype=torch.bool, device=device),
        capped_s=torch.zeros(shape_c, dtype=dtype, device=device),
        clear_s=torch.full(shape_c, torch.inf, dtype=dtype, device=device),
        throttled_s=torch.zeros(shape_l, dtype=dtype, device=device),
        last_t=torch.full(shape_c, -torch.inf, dtype=dtype, device=device))


def state_to_torch(st: EmergencyState, device) -> EmergencyState:
    """An oracle state as tensors on `device` (dtypes kept)."""
    return EmergencyState(*(torch.as_tensor(np.asarray(a), device=device)
                            for a in st))


def _numpy_order_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` adding the slices in the order numpy's pairwise
    summation adds a contiguous row: one running sum below 8 terms;
    eight accumulators, folded as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)),
    then the tail, up to 128; halves (cut at a multiple of 8) above.
    Every sum is a fixed sequence of elementwise adds, so it repeats bit
    for bit on the card and the CPU."""
    n = x.shape[dim]
    cols = x.unbind(dim)
    if n < 8:
        acc = cols[0]
        for c in cols[1:]:
            acc = acc + c
        return acc
    if n <= 128:
        r = list(cols[:8])
        i = 8
        while i < n - n % 8:
            r = [r[j] + cols[i + j] for j in range(8)]
            i += 8
        acc = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5])
                                                 + (r[6] + r[7]))
        for c in cols[i:]:
            acc = acc + c
        return acc
    half = n // 2
    half -= half % 8
    lo, hi = x.split([half, n - half], dim)
    return _numpy_order_sum(lo, dim) + _numpy_order_sum(hi, dim)


def chassis_rho_levels(gamma_nuf: torch.Tensor, gamma_uf: torch.Tensor,
                       chassis_servers: torch.Tensor) -> torch.Tensor:
    """`chassis_rho_levels_np` on tensors: one gather of both levels,
    then the K blade columns added in numpy's order — never a float
    `index_add` or `bincount`, whose order the card does not fix."""
    g = torch.stack([gamma_nuf, gamma_uf], -1)[chassis_servers]  # (C,K,L)
    return _numpy_order_sum(g, -2)


def _gtab(dtype, device) -> torch.Tensor:
    return torch.as_tensor(_gtab_np(_NP_DTYPE[dtype]), device=device)


def sampled_power(cfg: EmergencyConfig, rho_lv: torch.Tensor, util, pstate,
                  rapl) -> torch.Tensor:
    """`sampled_power_np` on tensors, in `rho_lv`'s dtype and device."""
    dtype, dev = rho_lv.dtype, rho_lv.device
    gtab = _gtab(dtype, dev)
    pstate = torch.as_tensor(pstate, device=dev).long()
    rapl = torch.as_tensor(rapl, dtype=torch.bool, device=dev)
    g = torch.where(rapl[..., None],
                    gtab[RaplController.backstop_pstate()], gtab[pstate])
    util = torch.as_tensor(util, dtype=dtype, device=dev)
    dyn = _scalar(cfg.p_dyn_per_core, dtype) * rho_lv * util[..., None]
    return _scalar(cfg.static_w, dtype) + (dyn * g).sum(-1)


def util_from_power(cfg: EmergencyConfig, rho_lv: torch.Tensor,
                    power_w: torch.Tensor) -> torch.Tensor:
    """`util_from_power_np` on tensors; it divides by a tensor."""
    dtype = rho_lv.dtype
    rho = rho_lv.sum(-1)
    dyn = torch.clamp(power_w - _scalar(cfg.static_w, dtype), min=0)
    pos = rho > 0
    return torch.where(
        pos, dyn / (_scalar(cfg.p_dyn_per_core, dtype)
                    * torch.where(pos, rho, 1.0)), 0.0)


def emergency_step(cfg: EmergencyConfig, st: EmergencyState,
                   rho_lv: torch.Tensor, util, t):
    """`emergency_step_np` on tensors: the same operations in the same
    order, in `rho_lv`'s dtype and on its device."""
    dtype, dev = rho_lv.dtype, rho_lv.device
    util = torch.as_tensor(util, dtype=dtype, device=dev)
    dyn_full = _scalar(cfg.p_dyn_per_core, dtype) * rho_lv * util[..., None]
    p_full = _scalar(cfg.static_w, dtype) + dyn_full.sum(-1)
    alarm = p_full >= _scalar(cfg.alert_w, dtype)

    tdt = st.last_t.dtype
    t = torch.as_tensor(t, dtype=tdt, device=dev)
    dt = torch.where(torch.isfinite(st.last_t),
                     torch.clamp(t - st.last_t, min=0), 0.0).to(dtype)

    was_thr = (st.pstate > 0) | st.rapl[..., None]
    throttled_s = st.throttled_s + dt[..., None] * was_thr
    was_capped = was_thr.any(-1)
    capped_accum = (st.capped_s + dt) * was_capped
    clear_accum = torch.where(alarm, 0.0,
                              torch.where(was_capped, st.clear_s + dt,
                                          torch.inf))
    lift = was_capped & ~alarm \
        & (clear_accum >= _scalar(cfg.lift_after_s, dtype))
    hold = was_capped & ~alarm & ~lift

    cut = torch.clamp(p_full - _scalar(cfg.target_w, dtype), min=0)
    pst_new, _, leftover = apportion_watts_torch(
        cut, dyn_full, cfg.floors, blind=cfg.criticality_blind)
    pstate = torch.where(alarm[..., None], pst_new,
                         torch.where(hold[..., None], st.pstate,
                                     torch.zeros_like(st.pstate)))
    rapl = torch.where(alarm, leftover > _scalar(_TOL_W, dtype),
                       hold & st.rapl)

    now_capped = (pstate > 0).any(-1) | rapl
    capped_s = torch.where(now_capped, capped_accum, 0.0).to(dtype)
    clear_s = torch.where(alarm, 0.0,
                          torch.where(now_capped, clear_accum,
                                      torch.inf)).to(dtype)
    last_t = torch.broadcast_to(t, st.last_t.shape).to(tdt).clone()

    p_after = sampled_power(cfg, rho_lv, util, pstate, rapl)
    gtab = _gtab(dtype, dev)
    g = torch.where(rapl[..., None],
                    gtab[RaplController.backstop_pstate()],
                    gtab[pstate.long()])
    cut_lv = dyn_full * (1 - g)
    st2 = EmergencyState(pstate, rapl, capped_s, clear_s,
                         throttled_s.to(dtype), last_t)
    return st2, EmergencyOutputs(p_full, p_after, alarm, cut, leftover,
                                 cut_lv)


def masked_step(cfg: EmergencyConfig, st: EmergencyState,
                rho_lv: torch.Tensor, power_w: torch.Tensor,
                mask: torch.Tensor, t):
    """`masked_step_np` on tensors."""
    util = util_from_power(cfg, rho_lv, power_w)
    st2, out = emergency_step(cfg, st, rho_lv, util, t)

    def sel(new, old):
        m = mask[..., None] if new.ndim == mask.ndim + 1 else mask
        return torch.where(m, new, old)

    st3 = EmergencyState(*(sel(n, o) for n, o in zip(st2, st)))
    zero = torch.zeros_like(out.power_w)
    return st3, EmergencyOutputs(
        torch.where(mask, out.power_w, zero),
        torch.where(mask, out.power_after_w, zero),
        mask & out.alarm,
        torch.where(mask, out.cut_w, zero),
        torch.where(mask, out.leftover_w, zero),
        torch.where(mask[..., None], out.cut_by_level_w, zero[..., None]))


def scatter_samples(n_chassis: int, chassis, power_w, t,
                    dtype=torch.float32, device=None):
    """`scatter_samples_np` as tensors on `device` (None: the card), every
    operand in `dtype` but the mask (as the reference's device form)."""
    device = resolve_device(device)
    pw, mask, ts = scatter_samples_np(n_chassis, chassis, power_w, t,
                                      np.float64)
    return (torch.as_tensor(pw, device=device).to(dtype),
            torch.as_tensor(mask, device=device),
            torch.as_tensor(ts, device=device).to(dtype))


def mitigation_due(cfg: EmergencyConfig, st: EmergencyState) -> torch.Tensor:
    """`mitigation_due_np` on tensors."""
    crit_thr = (st.pstate[..., CRIT_UF] > 0) | st.rapl
    return crit_thr & (st.capped_s >= _scalar(cfg.dwell_s,
                                              st.capped_s.dtype))


def reset_dwell(st: EmergencyState, chassis_mask) -> EmergencyState:
    """`reset_dwell_np` on tensors."""
    mask = torch.as_tensor(chassis_mask, dtype=torch.bool,
                           device=st.capped_s.device)
    return st._replace(capped_s=torch.where(mask, 0.0, st.capped_s))
