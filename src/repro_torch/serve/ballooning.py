"""Memory ballooning, the middle rung of the mitigation ladder (cap ->
balloon -> migrate), the counterpart of `repro.serve.ballooning`.

When a chassis alarms, the emergency plane first apportions the watt cut
across frequency floors (`serve.emergency`). If the cut exceeds what the
non-critical floor can absorb, the overflow throttles critical VMs and,
after a dwell, triggers live migration (`serve.mitigation`). The joint
(watts, cores, GB) ledger knows how much reclaimable memory the
chassis' non-user-facing VMs hold (`DeviceClusterState.mem_nuf`).
Ballooning it out powers its DRAM down and gives back ``w_per_gb`` watts
per GB without touching a critical core, so the rung fires exactly when
the NUF floor is not enough but the chassis has memory headroom.

How much to reclaim, in closed form. The sampled power model is affine
in utilization: ``p = static + dyn`` with ``dyn = p_dyn_per_core *
sum(rho_lv) * util``. Absorbing ``A`` watts of DRAM rescales the implied
utilization, and with it every level's full-frequency draw, by ``s =
(dyn - A) / dyn``. The critical level stays untouched iff the cut fits
inside the NUF floor's capacity at the adjusted utilization, ``cut - A
<= s * cap_nuf`` with ``cap_nuf = dyn_nuf * frac(floor_nuf)``, which
solves to the demand

    A* = (cut - cap_nuf) * dyn / (dyn - cap_nuf)        (when > 0)

`balloon_step` grabs ``min(A* / w_per_gb, headroom)`` GB, where
``headroom = reclaim_frac * mem_nuf - ballooned``. A fully served demand
leaves the next `emergency.masked_step` with the critical level at full
frequency and no RAPL leftover.

Every function exists twice, as in `serve.emergency`: the `*_np`
functions are the numpy oracle, array-equal to the reference's numpy
call, and the others are the torch twin, bit-equal to the oracle. The
twin takes its scalars rounded to the state's dtype (`emergency.
_scalar`) and divides only by tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.capping import reducible_fracs
from repro_torch.device import resolve_device
from repro_torch.serve.emergency import (_TOL_W, EmergencyConfig, _scalar,
                                         util_from_power, util_from_power_np)

#: Leftover or demand below this is float fuzz, not a deficit (the
#: emergency plane's own tolerance: one ladder, one epsilon).
TOL_W = _TOL_W


@dataclass(frozen=True)
class BallooningConfig:
    """Static knobs of the ballooning rung.

    w_per_gb:     DRAM power per resident GB, what powering a ballooned-
                  out GB down gives back (~3 W per 8 GB DIMM rank).
    reclaim_frac: fraction of a chassis' NUF-committed GB that ballooning
                  may reclaim (guest working sets keep the rest).
    """
    w_per_gb: float = 0.375
    reclaim_frac: float = 0.5


class BalloonState(NamedTuple):
    """Carried ballooning state; leading batch axes mirror
    `EmergencyState`. A numpy array for the oracle, a tensor for the
    twin."""
    ballooned_gb: Any    # (..., C) currently reclaimed GB per chassis


class BalloonOutputs(NamedTuple):
    """Per-step outputs of `balloon_step` (all (..., C))."""
    power_adj_w: Any     # sample less the DRAM absorption: what feeds
                         # `emergency.masked_step`
    reclaimed_gb: Any    # newly ballooned-out GB this step
    released_gb: Any     # GB handed back this step (alarm cleared)
    absorbed_w: Any      # total DRAM watts absorbed this step
    inflated: Any        # bool: the rung fired on this chassis


def _frac_nuf(ecfg: EmergencyConfig) -> float:
    """Fraction of the NUF level's dynamic draw its floor can shave."""
    return float(reducible_fracs()[ecfg.floors[0]])


# --- numpy oracle ---------------------------------------------------------

def init_ballooning_np(n_chassis: int, batch_shape: tuple = (),
                       dtype=np.float64) -> BalloonState:
    """All-deflated state (no memory ballooned out)."""
    return BalloonState(
        ballooned_gb=np.zeros(tuple(batch_shape) + (n_chassis,), dtype))


def balloon_demand_w_np(ecfg: EmergencyConfig, rho_lv, power_w):
    """(alarm, demand) of the closed form, from a raw power sample:
    ``alarm`` (..., C) bool mirrors the emergency step's alarm;
    ``demand`` (..., C) is the DRAM watt absorption that keeps the cut
    inside the NUF floor (0 where the floor suffices or no alarm)."""
    rho_lv = np.asarray(rho_lv)
    dtype = rho_lv.dtype
    util = util_from_power_np(ecfg, rho_lv, power_w)
    dyn_full = dtype.type(ecfg.p_dyn_per_core) * rho_lv * util[..., None]
    dyn = np.sum(dyn_full, axis=-1)
    p_full = dtype.type(ecfg.static_w) + dyn
    alarm = p_full >= dtype.type(ecfg.alert_w)
    cut = np.maximum(p_full - dtype.type(ecfg.target_w), 0)
    cap_nuf = dyn_full[..., 0] * dtype.type(_frac_nuf(ecfg))
    deficit = np.maximum(cut - cap_nuf, 0)
    denom = np.maximum(dyn - cap_nuf, dtype.type(TOL_W))
    # +TOL_W margin so the served demand lands the adjusted cut strictly
    # inside the NUF capacity: exact equality would let rounding tip an
    # epsilon share onto the critical level
    demand = np.where(alarm & (deficit > dtype.type(TOL_W)),
                      (deficit + dtype.type(TOL_W)) * dyn / denom,
                      dtype.type(0))
    return alarm, demand


def balloon_step_np(cfg: BallooningConfig, ecfg: EmergencyConfig,
                    st: BalloonState, rho_lv, power_w, mem_nuf_gb, mask):
    """One ballooning sweep over the chassis that sampled this step.

    rho_lv:     (..., C, L) per-criticality rho levels.
    power_w:    (..., C) raw sampled draws, not yet credited for standing
                balloons (this step owns that correction).
    mem_nuf_gb: (..., C) GB committed to NUF VMs.
    mask:       (..., C) bool, chassis that sampled this step; the others
                keep their state and pass their power through.

    The step credits the standing balloon against the sample (``p0 =
    power - w_per_gb * ballooned``), evaluates alarm and demand on that
    draw, inflates up to the headroom on alarmed chassis and deflates
    cleared ones fully (the returned GB draws power from the next sample
    on, so this step's ``power_adj_w`` still credits it). Feed
    ``power_adj_w`` to the emergency step in place of the raw sample.
    Returns ``(new_state, BalloonOutputs)``."""
    ballooned = np.asarray(st.ballooned_gb)
    dtype = ballooned.dtype
    w_per_gb = dtype.type(cfg.w_per_gb)
    mask = np.asarray(mask)
    power_w = np.asarray(power_w, dtype)

    standing_w = w_per_gb * ballooned
    p0 = power_w - standing_w
    alarm, demand_w = balloon_demand_w_np(ecfg, rho_lv, p0)

    headroom = np.maximum(
        dtype.type(cfg.reclaim_frac) * np.asarray(mem_nuf_gb, dtype)
        - ballooned, 0)
    want_gb = demand_w / w_per_gb
    grab = np.where(mask & alarm, np.minimum(want_gb, headroom),
                    dtype.type(0))
    release = np.where(mask & ~alarm, ballooned, dtype.type(0))
    ballooned_new = ballooned + grab - release

    absorbed = np.where(mask, standing_w + w_per_gb * grab, dtype.type(0))
    out = BalloonOutputs(power_adj_w=power_w - absorbed, reclaimed_gb=grab,
                         released_gb=release, absorbed_w=absorbed,
                         inflated=grab > dtype.type(TOL_W))
    return BalloonState(ballooned_gb=ballooned_new), out


def total_ballooned_gb(st: BalloonState) -> float:
    """Fleet-wide GB currently ballooned out, summed on the host, for
    either form of the state."""
    gb = st.ballooned_gb
    if torch.is_tensor(gb):
        gb = gb.cpu().numpy()
    return float(np.asarray(gb).sum())


# --- torch twin -----------------------------------------------------------

def init_ballooning(n_chassis: int, batch_shape: tuple = (),
                    dtype=torch.float64, device=None) -> BalloonState:
    """`init_ballooning_np` as a tensor on `device` (None: the card)."""
    return BalloonState(ballooned_gb=torch.zeros(
        tuple(batch_shape) + (n_chassis,), dtype=dtype,
        device=resolve_device(device)))


def state_to_torch(st: BalloonState, device) -> BalloonState:
    """An oracle state as a tensor on `device` (dtype kept)."""
    return BalloonState(torch.as_tensor(np.asarray(st.ballooned_gb),
                                        device=device))


def balloon_demand_w(ecfg: EmergencyConfig, rho_lv: torch.Tensor,
                     power_w: torch.Tensor):
    """`balloon_demand_w_np` on tensors: the same operations in the same
    order, in `rho_lv`'s dtype; the one division divides by a tensor."""
    dtype = rho_lv.dtype
    util = util_from_power(ecfg, rho_lv, power_w)
    dyn_full = _scalar(ecfg.p_dyn_per_core, dtype) * rho_lv * util[..., None]
    dyn = dyn_full.sum(-1)
    p_full = _scalar(ecfg.static_w, dtype) + dyn
    alarm = p_full >= _scalar(ecfg.alert_w, dtype)
    cut = torch.clamp(p_full - _scalar(ecfg.target_w, dtype), min=0)
    cap_nuf = dyn_full[..., 0] * _scalar(_frac_nuf(ecfg), dtype)
    deficit = torch.clamp(cut - cap_nuf, min=0)
    tol = _scalar(TOL_W, dtype)
    denom = torch.clamp(dyn - cap_nuf, min=tol)
    demand = torch.where(alarm & (deficit > tol),
                         (deficit + tol) * dyn / denom, 0.0)
    return alarm, demand


def balloon_step(cfg: BallooningConfig, ecfg: EmergencyConfig,
                 st: BalloonState, rho_lv: torch.Tensor, power_w, mem_nuf_gb,
                 mask):
    """`balloon_step_np` on tensors, in the state's dtype and on its
    device. ``want_gb`` divides by ``w_per_gb`` as a device tensor, not a
    Python scalar: the card would multiply by its rounded reciprocal."""
    ballooned = st.ballooned_gb
    dtype, dev = ballooned.dtype, ballooned.device
    w_per_gb = _scalar(cfg.w_per_gb, dtype)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    power_w = torch.as_tensor(power_w, device=dev).to(dtype)

    standing_w = w_per_gb * ballooned
    p0 = power_w - standing_w
    alarm, demand_w = balloon_demand_w(ecfg, rho_lv, p0)

    headroom = torch.clamp(
        _scalar(cfg.reclaim_frac, dtype)
        * torch.as_tensor(mem_nuf_gb, device=dev).to(dtype) - ballooned,
        min=0)
    want_gb = demand_w / ballooned.new_full((), w_per_gb)
    grab = torch.where(mask & alarm, torch.minimum(want_gb, headroom), 0.0)
    release = torch.where(mask & ~alarm, ballooned, 0.0)
    ballooned_new = ballooned + grab - release

    absorbed = torch.where(mask, standing_w + w_per_gb * grab, 0.0)
    out = BalloonOutputs(power_adj_w=power_w - absorbed, reclaimed_gb=grab,
                         released_gb=release, absorbed_w=absorbed,
                         inflated=grab > _scalar(TOL_W, dtype))
    return BalloonState(ballooned_gb=ballooned_new), out
