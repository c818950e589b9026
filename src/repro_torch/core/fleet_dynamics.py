"""Batched power-capping dynamics: one pure state-transition function,
the counterpart of `repro.core.fleet_dynamics`.

This is the heart of the paper's control plane (§III-D). The per-VM
controller, chassis manager and RAPL backstop of `core.capping` are thin
wrappers around `fleet_step`, a pure fixed-shape transition over padded
arrays:

    freq, pstate : (..., n_servers, n_cores)
    capping, rapl_active, clear_since : (..., n_servers)

The leading batch dims `...` are free: `()` for one server, `(B,)` for
a fleet of B chassis, `(G, H)` for a scenario grid. Every operation is
branchless (masked `where`, a greedy first-N selection).

The transition exists twice, on purpose:

  * the torch twin (`init_state`, `server_power`, `inband_step`,
    `rapl_step`, `fleet_step`) runs on device tensors of the state's
    device; `sim.fleet` steps it over time with the chassis as a batch
    dim;
  * the numpy oracle (`init_state_np`, ..., `fleet_step_np`) is the
    reference's `xp=numpy` arithmetic line for line, the validation
    oracle (`sim.fleet`'s ``backend="numpy"``).

The reference writes one body against an `xp` namespace, but it uses
`.astype`, numpy dtype scalars and Python-bool `where`s, which torch
does not take; so the twin is written out in torch. Two differences are
known and held by the reference's own numpy-vs-jax bars (0.5 W per
step): a sum over the core axis reduces in another order on the card
than numpy's pairwise sum, and with padded cores (`active` given)
numpy divides a float32 sum by an int64 count and promotes the mean
frequency, and so the server power, to float64, where the twin stays in
float32 like jnp.

Semantics are the paper's hybrid design: on a chassis alert the in-band
controller drops every non-user-facing core to the minimum p-state, then
feedback-raises/lowers N = 4 cores per 200 ms poll against the target
(budget - 5 W); the cap lifts 30 s after the alert clears; RAPL throttles
*all* cores equally as the out-of-band backstop.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.power_model import (CORES_PER_SERVER, CUBIC_MIX, F_MAX,
                                          F_MIN, N_PSTATES, P_IDLE_FMAX,
                                          P_IDLE_FMIN, P_PEAK_FMAX,
                                          ServerPowerModel,
                                          pstate_frequencies)

POLL_INTERVAL_S = 0.2       # 200 ms PSU polling
ALERT_MARGIN_W = 5.0        # controller target sits 5 W under the cap
LIFT_AFTER_S = 30.0         # cap lifted 30 s after alert clears
N_RAISE = 4                 # cores stepped up per feedback iteration
RAPL_STEP_FRAC = 0.05       # RAPL lowers all-core frequency 5 %/poll
                            # (reaches f_min from f_max within 2 s)
RAISE_HEADROOM_W = 2.0      # feedback-raise safety margin below target
PSU_TRIP_MARGIN_W = 2.0     # PSU averaging window: sub-poll transients
                            # this small do not trip the out-of-band path
ALERT_FRACTION = 0.97       # chassis manager alerts at 97 % of budget

#: p-state frequency table, descending f_max .. f_min (float32 so the
#: numpy oracle and the torch twin run the same precision).
FREQ_TABLE = pstate_frequencies(N_PSTATES).astype(np.float32)

_F32 = np.float32
_I32 = np.int32


class FleetState(NamedTuple):
    """Controller state for a (batch of) server(s); all fixed-shape."""
    freq: Any          # (..., S, C) float32, current core frequency
    pstate: Any        # (..., S, C) int32, index into FREQ_TABLE
    capping: Any       # (..., S) bool, in-band cap engaged
    rapl: Any          # (..., S) bool, out-of-band RAPL engaged
    clear_s: Any       # (..., S) float32, seconds since alert cleared


class RunParams(NamedTuple):
    """Per-run parameters. Scalars have shape `(...,)` (or are 0-d)
    matching the state's batch dims; masks have shape `(..., S, C)` or
    `(S, C)`. numpy arrays for the oracle, tensors on the state's device
    for the twin."""
    server_budget_w: Any      # hard per-server budget (RAPL trip level)
    target_w: Any             # in-band controller target (budget - 5 W)
    alert_w: Any              # chassis-manager alert threshold
    min_pstate: Any           # int, NUF frequency floor (p-state index)
    uf_mask: Any              # True = user-facing (never in-band capped)
    active: Any               # True = core exists (False = padding);
                              # None = every core active (no masking)


@dataclass(frozen=True)
class ControlParams:
    """Static (hashable) configuration."""
    mode: str = "per_vm"              # 'none' | 'rapl' | 'per_vm'
    dt: float = POLL_INTERVAL_S
    n_raise: int = N_RAISE
    alert_margin_w: float = ALERT_MARGIN_W
    lift_after_s: float = LIFT_AFTER_S
    rapl_step: float = RAPL_STEP_FRAC * F_MAX
    raise_headroom_w: float = RAISE_HEADROOM_W
    psu_trip_margin_w: float = PSU_TRIP_MARGIN_W
    #: keep calling the RAPL loop while a previous engagement restores
    #: (the chassis simulator does; the framework integration does not)
    rapl_continuation: bool = True
    #: power-model scalars (ServerPowerModel, flattened to hashables)
    p_dyn_per_core: float = (P_PEAK_FMAX - P_IDLE_FMAX) / CORES_PER_SERVER
    cubic_mix: float = CUBIC_MIX

    def __post_init__(self):
        if self.mode not in ("none", "rapl", "per_vm"):
            raise ValueError(f"unknown capping mode {self.mode!r}; "
                             "expected 'none' | 'rapl' | 'per_vm'")

    @classmethod
    def from_model(cls, model: ServerPowerModel, mode: str = "per_vm",
                   **kw) -> "ControlParams":
        return cls(mode=mode, p_dyn_per_core=model.p_dyn_per_core, **kw)


class StepOutputs(NamedTuple):
    server_power_w: Any      # (..., S) after control action
    chassis_power_w: Any     # (...,)
    alert: Any               # (...,) chassis-manager alert this poll
    rapl: Any                # (..., S) RAPL engaged after the step


#: composite selection keys fit int16 (level*(C+1)+idx <= 491 for the
#: 40-core blades); the narrow dtype halves the selection's traffic
_BIG_KEY = 2 ** 14


def _check_keys(n_cores: int, n_levels: int) -> None:
    if n_levels * (n_cores + 1) + n_cores >= _BIG_KEY:
        raise ValueError(
            f"n_cores={n_cores} overflows the int16 selection keys "
            f"(max ~{_BIG_KEY // (n_levels + 1) - 1} cores per server at "
            f"n_levels={n_levels}); widen _BIG_KEY/keys to int32 first")


# --- torch twin -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def freq_table(device: torch.device) -> torch.Tensor:
    """`FREQ_TABLE` as a float32 tensor on `device` (made once per device,
    so a step copies nothing from the host)."""
    return torch.as_tensor(FREQ_TABLE, device=device)


def init_state(batch_shape, n_servers: int, n_cores: int,
               device) -> FleetState:
    """Uncapped initial fleet state on `device` — every core at `F_MAX`,
    no RAPL, no capping — with the given leading batch shape."""
    shape_c = tuple(batch_shape) + (n_servers, n_cores)
    shape_s = tuple(batch_shape) + (n_servers,)
    return FleetState(
        freq=torch.full(shape_c, F_MAX, dtype=torch.float32, device=device),
        pstate=torch.zeros(shape_c, dtype=torch.int32, device=device),
        capping=torch.zeros(shape_s, dtype=torch.bool, device=device),
        rapl=torch.zeros(shape_s, dtype=torch.bool, device=device),
        clear_s=torch.full(shape_s, np.inf, dtype=torch.float32,
                           device=device))


def _per_server(x: torch.Tensor) -> torch.Tensor:
    """A run scalar of shape `(...,)` gains a trailing axis to broadcast
    against `(..., S)`; a 0-d one stays 0-d."""
    return x[..., None] if x.ndim else x


def _per_core(x: torch.Tensor) -> torch.Tensor:
    """A run scalar broadcast against `(..., S, C)` per-core arrays."""
    return x[..., None, None] if x.ndim else x


def server_power(util, freq, active, cp: ControlParams) -> torch.Tensor:
    """Server power draw, the calibrated model of `core.power_model`:
    P = P_idle(f_mean) + sum_c u_c * p_dyn * g(f_c). Padded cores are
    excluded from both the dynamic sum and the frequency mean."""
    fr = freq * (1.0 / F_MAX)
    g = cp.cubic_mix * fr * fr * fr + (1.0 - cp.cubic_mix) * fr
    ug = util * g
    if active is None:
        dyn = ug.sum(-1) * cp.p_dyn_per_core
        fmean = fr.mean(-1)
    else:
        dyn = torch.where(active, ug, 0.0).sum(-1) * cp.p_dyn_per_core
        fmean = torch.where(active, fr, 0.0).sum(-1) \
            / torch.clamp(active.sum(-1), min=1)
    idle = P_IDLE_FMIN + (P_IDLE_FMAX - P_IDLE_FMIN) * (2.0 * fmean - 1.0)
    return idle + dyn


def _first_n_mask(eligible, level, n_levels: int,
                  n_take: int) -> torch.Tensor:
    """Mask of the `n_take` eligible cores that come first by ascending
    (level, core index), by `n_take` min-passes over unique int16
    composite keys: exactly min(n_take, #eligible) cores pass, the same
    cores the numpy oracle picks."""
    n_cores = eligible.shape[-1]
    _check_keys(n_cores, n_levels)
    idx = torch.arange(n_cores, dtype=torch.int16, device=eligible.device)
    key = torch.where(eligible, level.to(torch.int16) * (n_cores + 1) + idx,
                      _BIG_KEY)
    sel = torch.zeros_like(eligible)
    for _ in range(n_take):
        kmin = key.amin(-1, keepdim=True)
        pick = (key == kmin) & (kmin < _BIG_KEY)
        sel = sel | pick
        key = torch.where(pick, _BIG_KEY, key)
    return sel


def inband_step(cp: ControlParams, rp: RunParams, st: FleetState, util,
                alert, p_in=None):
    """One in-band per-VM controller poll (paper Fig. 2 steps 4-5).
    `alert`: (..., S) bool. `p_in` optionally carries the already-polled
    entry power. Returns (new_state, power_after_action)."""
    table = freq_table(st.freq.device)
    active = rp.active
    low = ~rp.uf_mask if active is None else (~rp.uf_mask) & active
    minp = _per_core(rp.min_pstate)

    p0 = server_power(util, st.freq, active, cp) if p_in is None else p_in
    target = _per_server(rp.target_w)
    over_t = p0 > target
    start = alert & over_t & ~st.capping
    quiet = ~(alert | over_t)
    clear = torch.where(st.capping & quiet, st.clear_s + cp.dt, 0.0)
    lift = st.capping & (clear >= cp.lift_after_s)
    lower_c = st.capping & ~lift & over_t
    raise_c = st.capping & ~lift & ~over_t

    # one fused selection: lower_c and raise_c exclude each other per
    # server. lower: the N highest-frequency low-prio cores; raise: the
    # N lowest-frequency ones, committed only if the predicted power
    # keeps headroom below the target.
    lo_s = lower_c[..., None]
    eligible = low & torch.where(lo_s, st.pstate < minp,
                                 raise_c[..., None] & (st.pstate > 0))
    level = torch.where(lo_s, st.pstate, (N_PSTATES - 1) - st.pstate)
    sel = _first_n_mask(eligible, level, N_PSTATES, cp.n_raise)
    sel_lo = sel & lo_s
    sel_hi = sel & raise_c[..., None]
    trial = st.pstate - sel_hi.to(torch.int32)
    trial_p = server_power(util, table[trial.long()], active, cp)
    commit = raise_c & (trial_p < target - cp.raise_headroom_w)

    pstate = torch.where(start[..., None] & low, minp, st.pstate)
    pstate = torch.where(lift[..., None], 0, pstate)
    pstate = pstate + sel_lo.to(torch.int32)
    pstate = torch.where(commit[..., None], trial, pstate)

    capping = (st.capping | start) & ~lift
    rapl = st.rapl & ~lift
    clear_s = torch.where(start, 0.0, torch.where(st.capping & ~lift, clear,
                                                  np.inf))

    intended = table[pstate.long()]
    freq = torch.where(rapl[..., None], torch.minimum(intended, st.freq),
                       intended)
    if active is not None:
        freq = torch.where(active, freq, F_MAX)
    p1 = server_power(util, freq, active, cp)
    return FleetState(freq, pstate, capping, rapl, clear_s), p1


def rapl_step(cp: ControlParams, rp: RunParams, st: FleetState, util,
              engaged, p_in=None):
    """Out-of-band full-server capping (paper §II-B): throttle ALL cores
    equally while over the hard server budget; restore gradually, handing
    control back to the in-band p-state setting. `engaged`: (..., S)."""
    active = rp.active
    budget = _per_server(rp.server_budget_w)
    p1 = server_power(util, st.freq, active, cp) if p_in is None else p_in
    over = p1 > budget
    cut = engaged & over
    restore = engaged & ~over & st.rapl

    intended = freq_table(st.freq.device)[st.pstate.long()]
    if active is None:
        f_top = st.freq.amax(-1)
    else:
        f_top = torch.where(active, st.freq, F_MIN).amax(-1)
    uniform = torch.clamp(f_top - cp.rapl_step, min=F_MIN)
    freq = torch.where(cut[..., None],
                       torch.minimum(st.freq, uniform[..., None]), st.freq)
    do_raise = restore & (p1 < budget - 2.0 * cp.alert_margin_w)
    freq = torch.where(do_raise[..., None],
                       torch.minimum(freq + cp.rapl_step, intended), freq)
    reached = freq >= intended - 1e-9
    if active is None:
        done = reached.all(-1)
    else:
        freq = torch.where(active, freq, F_MAX)
        done = (reached | ~active).all(-1)
    rapl = cut | (st.rapl & ~(restore & done))
    p2 = server_power(util, freq, active, cp)
    return FleetState(freq, st.pstate, st.capping, rapl, st.clear_s), p2


def fleet_step(cp: ControlParams, rp: RunParams, st: FleetState,
               util) -> tuple:
    """One 200 ms poll of a whole (batch of) chassis on the state's
    device: PSU poll -> chassis-manager alert -> per-VM controllers ->
    RAPL backstop."""
    active = rp.active
    p0 = server_power(util, st.freq, active, cp)           # (..., S)
    chassis_p = p0.sum(-1)                                 # (...,)
    alert = chassis_p >= rp.alert_w

    if cp.mode == "none":
        return st, StepOutputs(p0, chassis_p, alert, st.rapl)
    if cp.mode == "rapl":
        engaged = torch.ones_like(p0, dtype=torch.bool)
        st2, p = rapl_step(cp, rp, st, util, engaged, p_in=p0)
    else:                                                  # 'per_vm'
        st1, p1 = inband_step(cp, rp, st, util,
                              alert[..., None].expand(p0.shape), p_in=p0)
        engaged = p1 > _per_server(rp.server_budget_w) + cp.psu_trip_margin_w
        if cp.rapl_continuation:
            engaged = engaged | st1.rapl
        st2, p = rapl_step(cp, rp, st1, util, engaged, p_in=p1)
    return st2, StepOutputs(p, p.sum(-1), alert, st2.rapl)


# --- numpy oracle (the reference's xp=numpy arithmetic) --------------------

def init_state_np(batch_shape, n_servers: int, n_cores: int) -> FleetState:
    """numpy `init_state`."""
    shape_c = tuple(batch_shape) + (n_servers, n_cores)
    shape_s = tuple(batch_shape) + (n_servers,)
    return FleetState(
        freq=np.full(shape_c, _F32(F_MAX), dtype=_F32),
        pstate=np.zeros(shape_c, dtype=_I32),
        capping=np.zeros(shape_s, dtype=bool),
        rapl=np.zeros(shape_s, dtype=bool),
        clear_s=np.full(shape_s, _F32(np.inf), dtype=_F32))


def _per_server_np(x):
    x = np.asarray(x)
    return x[..., None] if x.ndim else x


def _per_core_np(x):
    x = np.asarray(x)
    return x[..., None, None] if x.ndim else x


def server_power_np(util, freq, active, cp: ControlParams):
    """numpy `server_power` (float64 when `active` is given, see the
    module docstring)."""
    fr = np.asarray(freq, _F32) * _F32(1.0 / F_MAX)
    g = cp.cubic_mix * fr * fr * fr + (1.0 - cp.cubic_mix) * fr
    ug = np.asarray(util, _F32) * g
    if active is None:
        dyn = np.sum(ug, axis=-1) * _F32(cp.p_dyn_per_core)
        fmean = np.mean(fr, axis=-1)
    else:
        dyn = np.sum(np.where(active, ug, _F32(0.0)), axis=-1) \
            * _F32(cp.p_dyn_per_core)
        fmean = np.sum(np.where(active, fr, _F32(0.0)), axis=-1) \
            / np.maximum(np.sum(active, axis=-1), 1)
    idle = _F32(P_IDLE_FMIN) + _F32(P_IDLE_FMAX - P_IDLE_FMIN) \
        * (2.0 * fmean - 1.0)
    return idle + dyn


def _first_n_mask_np(eligible, level, n_levels: int, n_take: int):
    """numpy `_first_n_mask`."""
    n_cores = eligible.shape[-1]
    _check_keys(n_cores, n_levels)
    i16 = np.int16
    idx = np.arange(n_cores, dtype=i16)
    key = np.where(eligible, level.astype(i16) * i16(n_cores + 1) + idx,
                   i16(_BIG_KEY))
    sel = np.zeros(eligible.shape, dtype=bool)
    for _ in range(n_take):
        kmin = np.min(key, axis=-1)
        pick = (key == kmin[..., None]) & (kmin < _BIG_KEY)[..., None]
        sel = sel | pick
        key = np.where(pick, i16(_BIG_KEY), key)
    return sel


def inband_step_np(cp: ControlParams, rp: RunParams, st: FleetState,
                   util, alert, p_in=None):
    """numpy `inband_step`."""
    table = FREQ_TABLE
    active = rp.active
    low = ~rp.uf_mask if active is None else (~rp.uf_mask) & active
    minp = _per_core_np(rp.min_pstate)

    p0 = server_power_np(util, st.freq, active, cp) \
        if p_in is None else p_in
    target = _per_server_np(rp.target_w)
    over_t = p0 > target
    start = alert & over_t & ~st.capping
    quiet = ~(alert | over_t)
    clear = np.where(st.capping & quiet, st.clear_s + _F32(cp.dt),
                     _F32(0.0))
    lift = st.capping & (clear >= _F32(cp.lift_after_s))
    lower_c = st.capping & ~lift & over_t
    raise_c = st.capping & ~lift & ~over_t

    lo_s = lower_c[..., None]
    eligible = low & np.where(lo_s, st.pstate < minp,
                              raise_c[..., None] & (st.pstate > 0))
    level = np.where(lo_s, st.pstate, _I32(N_PSTATES - 1) - st.pstate)
    sel = _first_n_mask_np(eligible, level, N_PSTATES, cp.n_raise)
    sel_lo = sel & lo_s
    sel_hi = sel & raise_c[..., None]
    trial = st.pstate - sel_hi.astype(_I32)
    trial_p = server_power_np(util, table[trial], active, cp)
    commit = raise_c & (trial_p < target - _F32(cp.raise_headroom_w))

    pstate = np.where(start[..., None] & low, minp, st.pstate)
    pstate = np.where(lift[..., None], _I32(0), pstate)
    pstate = pstate + np.where(sel_lo, _I32(1), _I32(0))
    pstate = np.where(commit[..., None], trial, pstate)

    capping = (st.capping | start) & ~lift
    rapl = st.rapl & ~lift
    clear_s = np.where(start, _F32(0.0),
                       np.where(st.capping & ~lift, clear, _F32(np.inf)))

    intended = table[pstate]
    freq = np.where(rapl[..., None], np.minimum(intended, st.freq),
                    intended)
    if active is not None:
        freq = np.where(active, freq, _F32(F_MAX))
    p1 = server_power_np(util, freq, active, cp)
    return FleetState(freq, pstate, capping, rapl, clear_s), p1


def rapl_step_np(cp: ControlParams, rp: RunParams, st: FleetState, util,
                 engaged, p_in=None):
    """numpy `rapl_step`."""
    active = rp.active
    budget = _per_server_np(rp.server_budget_w)
    p1 = server_power_np(util, st.freq, active, cp) \
        if p_in is None else p_in
    over = p1 > budget
    cut = engaged & over
    restore = engaged & ~over & st.rapl

    intended = FREQ_TABLE[st.pstate]
    if active is None:
        f_top = np.max(st.freq, axis=-1)
    else:
        f_top = np.max(np.where(active, st.freq, _F32(F_MIN)), axis=-1)
    uniform = np.maximum(f_top - _F32(cp.rapl_step), _F32(F_MIN))
    freq = np.where(cut[..., None],
                    np.minimum(st.freq, uniform[..., None]), st.freq)
    do_raise = restore & (p1 < budget - _F32(2.0 * cp.alert_margin_w))
    freq = np.where(do_raise[..., None],
                    np.minimum(freq + _F32(cp.rapl_step), intended), freq)
    reached = freq >= intended - _F32(1e-9)
    if active is None:
        done = np.all(reached, axis=-1)
    else:
        freq = np.where(active, freq, _F32(F_MAX))
        done = np.all(reached | ~active, axis=-1)
    rapl = np.where(cut, True, np.where(restore & done, False, st.rapl))
    p2 = server_power_np(util, freq, active, cp)
    return FleetState(freq, st.pstate, st.capping, rapl, st.clear_s), p2


def fleet_step_np(cp: ControlParams, rp: RunParams, st: FleetState,
                  util) -> tuple:
    """numpy `fleet_step`, the oracle."""
    active = rp.active
    p0 = server_power_np(util, st.freq, active, cp)
    chassis_p = np.sum(p0, axis=-1)
    alert = chassis_p >= np.asarray(rp.alert_w)

    if cp.mode == "none":
        return st, StepOutputs(p0, chassis_p, alert, st.rapl)
    if cp.mode == "rapl":
        engaged = np.ones(p0.shape, dtype=bool)
        st2, p = rapl_step_np(cp, rp, st, util, engaged, p_in=p0)
    else:
        st1, p1 = inband_step_np(cp, rp, st, util,
                                 np.broadcast_to(alert[..., None], p0.shape),
                                 p_in=p0)
        engaged = p1 > _per_server_np(rp.server_budget_w) \
            + _F32(cp.psu_trip_margin_w)
        if cp.rapl_continuation:
            engaged = engaged | st1.rapl
        st2, p = rapl_step_np(cp, rp, st1, util, engaged, p_in=p1)
    return st2, StepOutputs(p, np.sum(p, axis=-1), alert, st2.rapl)
