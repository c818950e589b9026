"""Per-VM power capping controller + full-server RAPL model (paper §III-D),
the counterpart of `repro.core.capping`.

The hybrid design, faithful to the paper:

  * the chassis manager polls PSUs every 200 ms and alerts the in-band
    per-VM controller when chassis draw crosses a threshold *just below*
    the chassis budget (budget - ALERT_MARGIN_W, the paper's 225 W target
    for a 230 W cap);
  * on alert, the controller immediately drops every low-priority
    (non-user-facing) core to the minimum p-state (f_max/2);
  * it then runs a feedback loop: each iteration reads the server power
    meter and raises N = 4 low-priority cores to the next higher p-state
    while power stays below the target, or lowers them if above;
  * the cap is lifted LIFT_AFTER_S = 30 s after the alert clears;
  * out-of-band backup: if power still exceeds the *server* budget (PSU
    alert -> BMC), RAPL throttles ALL cores equally (user-facing
    included) until under. RAPL converges within ~2 s.

The classes here are small per-server host objects kept for the object
API; their transition is `core.fleet_dynamics`'s numpy oracle
(`inband_step_np`, `rapl_step_np`), so they step exactly as the
reference's classes do. Fleets run the torch twin through `sim.fleet`
and `runtime.power_control`. `apportion_watts` exists as numpy and as a
torch twin (`apportion_watts_torch`), since the reference's `xp` body
uses `.astype`.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core.fleet_dynamics import (ALERT_FRACTION, ALERT_MARGIN_W,
                                             FREQ_TABLE, LIFT_AFTER_S,
                                             N_RAISE, POLL_INTERVAL_S,
                                             PSU_TRIP_MARGIN_W,
                                             RAISE_HEADROOM_W, RAPL_STEP_FRAC,
                                             ControlParams, FleetState,
                                             RunParams, inband_step_np,
                                             rapl_step_np)
from repro_torch.core.power_model import (F_MAX, N_PSTATES, ServerPowerModel,
                                          dyn_scale, pstate_frequencies)

__all__ = ["POLL_INTERVAL_S", "ALERT_MARGIN_W", "LIFT_AFTER_S", "N_RAISE",
           "RAPL_STEP_FRAC", "RAISE_HEADROOM_W", "PSU_TRIP_MARGIN_W",
           "ServerCapState", "PerVMController", "RaplController",
           "ChassisManager", "reducible_fracs", "apportion_watts",
           "apportion_watts_torch"]


def reducible_fracs() -> np.ndarray:
    """(P,) fraction of a class's full-frequency *dynamic* power shaved
    by capping its cores uniformly to p-state p: ``1 - g(FREQ_TABLE[p])``,
    ascending from 0 (p-state 0 = f_max) to ``1 - g(f_min)`` (~0.707
    under the calibrated model). The lookup table every watt-cut
    apportionment below inverts."""
    return 1.0 - dyn_scale(FREQ_TABLE)


def apportion_watts(cut_w, dyn_w, floors, blind: bool = False):
    """Apportion a required watt cut across criticality levels,
    lowest-criticality-first (paper §III-D: non-user-facing cores are
    capped before user-facing ones). numpy; `apportion_watts_torch` is
    its twin on tensors.

    cut_w:  (...,) required reduction of dynamic draw, watts.
    dyn_w:  (..., L) full-frequency dynamic draw per criticality level,
            in apportionment priority order (level 0 is cut first).
    floors: (L,) int — deepest p-state each level may be capped to by
            the criticality-aware stage (the per-level frequency floor).
    blind:  apportion the cut proportionally to each level's draw
            instead (the criticality-blind baseline).

    Returns ``(pstate, take_w, leftover_w)``: the per-level uniform
    p-state (smallest index whose reducible fraction covers the level's
    share), the watt share assigned to each level, and the cut that no
    level could absorb within its floor — ``leftover_w > 0`` is the
    RAPL-backstop trigger. A level with no dynamic draw takes no share
    and stays at p-state 0 (no division by its zero draw); when the
    low-criticality levels cannot absorb the cut, the cascade caps the
    critical levels down to their own floor before any leftover falls
    through to RAPL.
    """
    dyn_w = np.asarray(dyn_w)
    dtype = dyn_w.dtype
    fracs = np.asarray(reducible_fracs(), dtype)
    floors = np.asarray(floors, np.int32)
    cut = np.maximum(np.asarray(cut_w, dtype), 0)
    red_max = dyn_w * fracs[floors]                     # (..., L)
    if blind:
        total = np.sum(dyn_w, axis=-1, keepdims=True)
        share = np.where(total > 0,
                         dyn_w / np.where(total > 0, total, 1), 0)
        take = np.minimum(cut[..., None] * share, red_max)
    else:
        cum = np.cumsum(red_max, axis=-1) - red_max     # exclusive
        take = np.clip(cut[..., None] - cum, 0, red_max)
    leftover = np.maximum(cut - np.sum(take, axis=-1), 0)
    ratio = np.where(dyn_w > 0, take / np.where(dyn_w > 0, dyn_w, 1), 0)
    pstate = np.sum((fracs < ratio[..., None]).astype(np.int32), axis=-1)
    pstate = np.minimum(pstate, floors)
    return pstate, take, leftover


def apportion_watts_torch(cut_w, dyn_w: torch.Tensor, floors,
                          blind: bool = False):
    """`apportion_watts` on tensors, on `dyn_w`'s device and in its dtype.
    The p-states come back as int32."""
    dtype, dev = dyn_w.dtype, dyn_w.device
    fracs = torch.as_tensor(reducible_fracs(), dtype=dtype, device=dev)
    floors = torch.as_tensor(np.asarray(floors, np.int64), device=dev)
    cut = torch.clamp(torch.as_tensor(cut_w, dtype=dtype, device=dev), min=0)
    red_max = dyn_w * fracs[floors]
    if blind:
        total = dyn_w.sum(-1, keepdim=True)
        share = torch.where(total > 0,
                            dyn_w / torch.where(total > 0, total, 1.0), 0.0)
        take = torch.minimum(cut[..., None] * share, red_max)
    else:
        cum = torch.cumsum(red_max, -1) - red_max
        take = torch.minimum(torch.clamp(cut[..., None] - cum, min=0),
                             red_max)
    leftover = torch.clamp(cut - take.sum(-1), min=0)
    ratio = torch.where(dyn_w > 0, take / torch.where(dyn_w > 0, dyn_w, 1.0),
                        0.0)
    pstate = (fracs < ratio[..., None]).sum(-1)
    pstate = torch.minimum(pstate, floors).to(torch.int32)
    return pstate, take, leftover


@dataclass
class ServerCapState:
    """Mutable controller state for one server."""
    n_cores: int
    uf_mask: np.ndarray                       # (n_cores,) True = high-prio
    freq: np.ndarray = field(default=None)    # (n_cores,) current frequency
    pstate: np.ndarray = field(default=None)  # (n_cores,) index into table
    capping: bool = False
    rapl_active: bool = False
    clear_since_s: float = np.inf             # time since alert cleared

    def __post_init__(self):
        if self.freq is None:
            self.freq = np.full(self.n_cores, F_MAX, dtype=np.float32)
        if self.pstate is None:
            self.pstate = np.zeros(self.n_cores, dtype=np.int32)

    def _pack(self) -> FleetState:
        """View as a (1, n_cores) fleet state for the shared transition."""
        return FleetState(
            freq=np.asarray(self.freq, np.float32).reshape(1, -1),
            pstate=np.asarray(self.pstate, np.int32).reshape(1, -1),
            capping=np.array([self.capping]),
            rapl=np.array([self.rapl_active]),
            clear_s=np.array([self.clear_since_s], np.float32))

    def _unpack(self, fs: FleetState) -> None:
        self.freq = np.asarray(fs.freq[0])
        self.pstate = np.asarray(fs.pstate[0])
        self.capping = bool(fs.capping[0])
        self.rapl_active = bool(fs.rapl[0])
        self.clear_since_s = float(fs.clear_s[0])

    def _run_params(self, budget_w: float) -> RunParams:
        return RunParams(
            server_budget_w=np.float32(budget_w),
            target_w=np.float32(budget_w - ALERT_MARGIN_W),
            alert_w=np.float32(np.inf),
            min_pstate=np.int32(N_PSTATES - 1),
            uf_mask=np.asarray(self.uf_mask, bool).reshape(1, -1),
            active=None)


class PerVMController:
    """In-band controller for one server (paper Fig. 2 steps 4-5)."""

    def __init__(self, model: ServerPowerModel, server_budget_w: float):
        self.model = model
        self.budget = server_budget_w
        self.target = server_budget_w - ALERT_MARGIN_W
        self.freq_table = pstate_frequencies(N_PSTATES)  # descending
        self.min_pstate = N_PSTATES - 1
        self._cp = ControlParams.from_model(model, mode="per_vm")

    def step(self, st: ServerCapState, util: np.ndarray, alert: bool,
             dt: float = POLL_INTERVAL_S) -> float:
        """One 200 ms control step. `util` = per-core utilization (0-1),
        `alert` = chassis-manager alert. Returns the server power draw
        AFTER the control action (what the next poll would read)."""
        cp = self._cp if dt == self._cp.dt else replace(self._cp, dt=dt)
        fs, p = inband_step_np(
            cp, st._run_params(self.budget), st._pack(),
            np.asarray(util, np.float32).reshape(1, -1),
            np.array([alert]))
        st._unpack(fs)
        return float(p[0])

    def apportion(self, cut_w, dyn_w, floors=None, blind: bool = False):
        """Apportion a required watt cut across criticality classes —
        the model-predictive twin of the feedback loop in `step`, used
        when the controller *knows* each class's committed dynamic draw
        (the serve plane's emergency path knows it exactly from the
        placement aggregates).

        `dyn_w`: (..., L) full-frequency dynamic watts per class in
        priority order (non-user-facing first); `floors`: per-class
        p-state floors (defaults to this controller's `min_pstate` for
        every class). Delegates to `apportion_watts` — including its
        zero-util-class guard and the critical-before-RAPL cascade —
        and returns the same ``(pstate, take_w, leftover_w)``."""
        dyn_w = np.asarray(dyn_w)
        if floors is None:
            floors = np.full(dyn_w.shape[-1], self.min_pstate, np.int32)
        return apportion_watts(cut_w, dyn_w, floors, blind=blind)


class RaplController:
    """Out-of-band full-server capping (existing mechanism, and the
    backup when per-VM capping is insufficient). Throttles the whole
    socket — all cores equally (paper §II-B)."""

    def __init__(self, model: ServerPowerModel, server_budget_w: float):
        self.model = model
        self.budget = server_budget_w
        self._cp = ControlParams.from_model(model, mode="rapl")

    def step(self, st: ServerCapState, util: np.ndarray,
             dt: float = POLL_INTERVAL_S) -> float:
        fs, p = rapl_step_np(
            self._cp, st._run_params(self.budget), st._pack(),
            np.asarray(util, np.float32).reshape(1, -1),
            np.ones(1, bool))
        st._unpack(fs)
        return float(p[0])

    @staticmethod
    def backstop_pstate() -> int:
        """P-state RAPL converges to when it must shed maximum power:
        every core at f_min, criticality-blind (paper §II-B). The serve
        emergency plane forces all classes here when the apportionment
        reports a leftover no floor could absorb."""
        return N_PSTATES - 1


@dataclass(frozen=True)
class ChassisManager:
    """Polls PSUs and raises alerts (paper Fig. 2 step 4). The alert
    threshold sits just below the chassis budget so the in-band
    controller can act before the PSU->BMC hardware path must.

    Batched-friendly: `poll` accepts scalar or array draws (the serve
    emergency plane polls every chassis of a shard at once), and the
    `alert_w`/`target_w` properties expose the thresholds the batched
    kernels need as plain floats."""
    chassis_budget_w: float
    alert_fraction: float = ALERT_FRACTION
    target_margin_w: float = ALERT_MARGIN_W

    @property
    def alert_threshold_w(self) -> float:
        return self.chassis_budget_w * self.alert_fraction

    @property
    def alert_w(self) -> float:
        """Alias of `alert_threshold_w` (the batched kernels' name)."""
        return self.alert_threshold_w

    @property
    def target_w(self) -> float:
        """Power level capping steers to once alerted: the budget minus
        the controller margin (the paper's 225 W target for a 230 W
        cap)."""
        return self.chassis_budget_w - self.target_margin_w

    def poll(self, chassis_power_w):
        """Alert mask: draw at/above the alert threshold. Scalar in,
        bool out; array in, bool-array out (one poll per chassis)."""
        return chassis_power_w >= self.alert_threshold_w
