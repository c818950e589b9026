"""Closed-loop adaptive oversubscription, the counterpart of
`repro.serve.adaptive`.

The paper picks its oversubscription ratio offline from historical
utilization percentiles (§IV, Table 4); this module closes the loop
online. Every chassis power sample of the ingest stream (the CAPPING
event kind of `serve.ingest`) lands in a rolling per-chassis utilization
window, and each scan scores every window:

  * **percentile spread**: the distance between a low and a high
    percentile of the window; a tight band means a predictable draw;
  * **sign-change rate**: the fraction of consecutive utilization deltas
    that reverse direction; few reversals mean a trend, not thrashing.

A chassis whose window is long enough (``min_history``), whose spread and
flip rate are under their thresholds and whose latest sample is at or
below ``hot_util`` is **stable**. The fleet controller ratchets up slowly
and backs off fast:

  * the stable share of known chassis reaches ``ratchet_quorum`` and
    nothing runs hot: the ratio creeps up by ``step_up``;
  * a chassis runs hot or the stable share drops below
    ``backoff_quorum``: the ratio falls by ``step_down``;
  * otherwise it holds, clamped to ``[ratio_min, ratio_max]``, starting
    at 1.0 (no history, no oversubscription).

The ratio scales the per-chassis admission ceiling between micro-batches
(`ServePipeline.rho_cap`). Tokens committed to placed VMs are never
revoked: `retarget_pool` only drains the free pool, floored at zero.

The step exists twice, as in `serve.emergency`: `adaptive_step_np` is
the numpy oracle, array-equal to the reference's numpy call, and
`adaptive_step` the torch twin, bit-equal to it in float32 and float64.
Cross-chassis reductions are integer sums, percentiles are a sort and
integer-index gathers, scalars enter rounded to the state's dtype, and
the divisions divide by tensors. `offered_power` and `retarget_pool` are
host numpy, as the simulation and the token pools use them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.power_model import F_MAX, ServerPowerModel, idle_power
from repro_torch.device import resolve_device
from repro_torch.serve.emergency import _scalar

#: Names of the controller's decision reasons (`decision_reason`).
REASON_NAMES = (
    "hold_no_history",      # 0: no chassis has enough window yet
    "hold_band",            # 1: stable share between the quorums
    "ratchet_quorum",       # 2: stable quorum met -> step up
    "ratchet_ceiling",      # 3: quorum met but ratio pinned at max
    "backoff_hot",          # 4: a chassis ran hot -> step down fast
    "backoff_quorum",       # 5: stable share under the floor quorum
    "backoff_floor",        # 6: back-off demanded but ratio at min
)


@dataclass(frozen=True)
class AdaptiveConfig:
    """Static knobs of the adaptive-ratio controller.

    A window is stable when its ``[spread_q_lo, spread_q_hi]`` percentile
    spread is at most ``spread_thresh``, its sign-change rate at most
    ``flip_thresh`` and its latest sample at or below ``hot_util``.
    ``step_down`` should be several times ``step_up``. The power-model
    fields read power samples back as utilization like
    `serve.emergency.util_from_power`. ``hold_on_stale`` clamps the
    applied ratio to ``ratio_min`` while the prediction scorecard reports
    a stale model; without that scorecard it has no effect."""
    window: int = 16
    min_history: int = 4
    spread_q_lo: float = 0.1
    spread_q_hi: float = 0.9
    spread_thresh: float = 0.25
    flip_thresh: float = 0.6
    hot_util: float = 0.85
    ratchet_quorum: float = 0.9
    backoff_quorum: float = 0.5
    step_up: float = 0.05
    step_down: float = 0.25
    ratio_min: float = 1.0
    ratio_max: float = 2.0
    blades_per_chassis: int = 12
    p_dyn_per_core: float = ServerPowerModel().p_dyn_per_core
    idle_w_per_server: float = float(idle_power(F_MAX))
    hold_on_stale: bool = False

    def __post_init__(self):
        if self.window < 2:
            raise ValueError(f"window must be >= 2, got {self.window}")
        if not 1 <= self.min_history <= self.window:
            raise ValueError(
                f"min_history must be in [1, window={self.window}], "
                f"got {self.min_history}")
        if not 0 <= self.spread_q_lo < self.spread_q_hi <= 1:
            raise ValueError(
                f"need 0 <= spread_q_lo < spread_q_hi <= 1, got "
                f"({self.spread_q_lo}, {self.spread_q_hi})")
        if not self.backoff_quorum <= self.ratchet_quorum:
            raise ValueError(
                f"backoff_quorum {self.backoff_quorum} must not exceed "
                f"ratchet_quorum {self.ratchet_quorum} (the hold band "
                "between them damps oscillation)")
        if not 0 < self.ratio_min <= self.ratio_max:
            raise ValueError(
                f"need 0 < ratio_min <= ratio_max, got "
                f"({self.ratio_min}, {self.ratio_max})")
        if self.step_up <= 0 or self.step_down <= 0:
            raise ValueError("step_up and step_down must be positive")

    @property
    def static_w(self) -> float:
        """Frequency-independent chassis floor (watts): every blade's idle
        draw, subtracted before a sample is read back as utilization."""
        return self.blades_per_chassis * self.idle_w_per_server

    @classmethod
    def from_model(cls, model: ServerPowerModel | None = None,
                   **kw) -> "AdaptiveConfig":
        """Build a config calibrated to a `ServerPowerModel`."""
        model = model or ServerPowerModel()
        return cls(p_dyn_per_core=model.p_dyn_per_core, **kw)


class AdaptiveState(NamedTuple):
    """Controller state, fixed-shape, with optional leading batch dims.
    ``util`` is a per-chassis ring buffer: ``head`` is the next write
    slot and ``count`` saturates at the window length."""
    util: Any          # (..., C, W) rolling utilization samples
    count: Any         # (..., C) int32 valid samples, saturates at W
    head: Any          # (..., C) int32 ring write position
    ratio: Any         # (...,) current oversubscription ratio
    ratchets: Any      # (...,) int32 cumulative up-steps
    backoffs: Any      # (...,) int32 cumulative down-steps


class AdaptiveOutputs(NamedTuple):
    """Per-scan observables of one controller step."""
    ratio: Any         # (...,) post-step ratio
    stable_frac: Any   # (...,) stable / known chassis (0 if none)
    n_known: Any       # (...,) chassis with enough history
    n_stable: Any      # (...,) known chassis scored stable
    ratchet: Any       # (...,) bool stepped up this scan
    backoff: Any       # (...,) bool stepped down this scan
    hot: Any           # (...,) bool some chassis over hot_util
    spread: Any        # (..., C) percentile-spread score
    flip_rate: Any     # (..., C) sign-change-rate score
    stable: Any        # (..., C) bool per-chassis verdict


# --- numpy oracle ---------------------------------------------------------

def init_adaptive_np(cfg: AdaptiveConfig, n_chassis: int, batch_shape=(),
                     dtype=np.float32) -> AdaptiveState:
    """Fresh controller state at ratio 1.0 with empty windows."""
    shape_c = tuple(batch_shape) + (n_chassis,)
    return AdaptiveState(
        util=np.zeros(shape_c + (cfg.window,), dtype),
        count=np.zeros(shape_c, np.int32),
        head=np.zeros(shape_c, np.int32),
        ratio=np.ones(batch_shape, dtype),
        ratchets=np.zeros(batch_shape, np.int32),
        backoffs=np.zeros(batch_shape, np.int32))


def offered_power(cfg: AdaptiveConfig, rho_lv, util):
    """Chassis draw implied by committed per-level ``p95*cores`` at a
    utilization sample, ``static + p_dyn * sum_l rho_l * util`` (host
    numpy): the synthetic power feed the simulation pushes through the
    controller."""
    rho = np.sum(np.asarray(rho_lv), axis=-1)
    return cfg.static_w + cfg.p_dyn_per_core * rho * np.asarray(util)


def _util_from_power_np(cfg: AdaptiveConfig, rho_lv, power_w):
    """Inverse of `offered_power`; a chassis with nothing committed reads
    as idle."""
    rho = np.sum(rho_lv, axis=-1)
    dyn = np.maximum(np.asarray(power_w) - cfg.static_w, 0)
    return np.where(rho > 0,
                    dyn / (cfg.p_dyn_per_core * np.where(rho > 0, rho, 1)),
                    0.0)


def adaptive_step_np(cfg: AdaptiveConfig, st: AdaptiveState, rho_lv,
                     power_w, mask):
    """One controller scan over a (batch of) chassis.

    rho_lv: (..., C, L) committed ``p95*cores`` per criticality level,
    which reads the masked power samples back as utilization;
    power_w/mask: (..., C), only ``mask`` rows carry a fresh sample
    (unmasked chassis keep their window and are still scored). Returns
    ``(new_state, AdaptiveOutputs)``."""
    rho_lv = np.asarray(rho_lv)
    dtype = rho_lv.dtype
    W = cfg.window
    u_new = _util_from_power_np(cfg, rho_lv, power_w).astype(dtype)

    # masked ring write: one-hot at head, then advance head and count
    slot = np.arange(W, dtype=np.int32)
    write = mask[..., None] & (slot == st.head[..., None])
    util = np.where(write, u_new[..., None], np.asarray(st.util, dtype))
    count = np.where(mask, np.minimum(st.count + 1, W), st.count)
    head = np.where(mask, (st.head + 1) % W, st.head)

    # chronological view, oldest first; the valid samples are the
    # trailing `count` entries
    idx = (head[..., None] + slot) % W
    chrono = np.take_along_axis(util, idx.astype(np.int32), axis=-1)
    valid = slot >= (W - count)[..., None]

    # percentile spread: sort with invalid entries pushed to +inf, then
    # gather at floor(q * (n-1)), never an interpolating percentile
    inf = dtype.type(np.inf)
    svals = np.sort(np.where(valid, chrono, inf), axis=-1)
    nm1 = np.maximum(count - 1, 0).astype(dtype)
    i_lo = (dtype.type(cfg.spread_q_lo) * nm1).astype(np.int32)
    i_hi = (dtype.type(cfg.spread_q_hi) * nm1).astype(np.int32)
    q_lo = np.take_along_axis(svals, i_lo[..., None], axis=-1)[..., 0]
    q_hi = np.take_along_axis(svals, i_hi[..., None], axis=-1)[..., 0]
    zero = np.zeros_like(q_lo)
    q_lo = np.where(np.isfinite(q_lo), q_lo, zero)
    q_hi = np.where(np.isfinite(q_hi), q_hi, zero)
    spread = q_hi - q_lo

    # sign-change rate over consecutive valid deltas (validity is a
    # suffix, so a pair is valid iff its left end is)
    d = np.where(valid[..., :-1], chrono[..., 1:] - chrono[..., :-1], 0)
    flips = np.sum(
        ((np.sign(d[..., 1:]) * np.sign(d[..., :-1])) < 0).astype(np.int32),
        axis=-1)
    flip_rate = flips.astype(dtype) / np.maximum(count - 2, 1).astype(dtype)

    latest = chrono[..., -1]
    hot_c = (count >= 1) & (latest > dtype.type(cfg.hot_util))
    known = count >= cfg.min_history
    stable = known & (spread <= dtype.type(cfg.spread_thresh)) \
        & (flip_rate <= dtype.type(cfg.flip_thresh)) & ~hot_c

    # fleet decision: integer sums keep the reduction exact
    n_known = np.sum(known.astype(np.int32), axis=-1)
    n_stable = np.sum(stable.astype(np.int32), axis=-1)
    hot = np.sum(hot_c.astype(np.int32), axis=-1) > 0
    frac = n_stable.astype(dtype) / np.maximum(n_known, 1).astype(dtype)
    ratchet = (n_known > 0) & ~hot \
        & (frac >= dtype.type(cfg.ratchet_quorum))
    backoff = hot | ((n_known > 0)
                     & (frac < dtype.type(cfg.backoff_quorum)))
    ratio = np.clip(
        np.asarray(st.ratio, dtype)
        + dtype.type(cfg.step_up) * ratchet.astype(dtype)
        - dtype.type(cfg.step_down) * backoff.astype(dtype),
        dtype.type(cfg.ratio_min), dtype.type(cfg.ratio_max))

    st2 = AdaptiveState(util=util, count=count, head=head, ratio=ratio,
                        ratchets=st.ratchets + ratchet.astype(np.int32),
                        backoffs=st.backoffs + backoff.astype(np.int32))
    return st2, AdaptiveOutputs(
        ratio=ratio, stable_frac=frac, n_known=n_known, n_stable=n_stable,
        ratchet=ratchet, backoff=backoff, hot=hot, spread=spread,
        flip_rate=flip_rate, stable=stable)


def retarget_pool(cfg: AdaptiveConfig, base_pool, ratio, committed):
    """Free-pool level after the controller retargets the allowance:
    ``max(base_pool * ratio - committed, 0)`` (host numpy). ``base_pool`` is the
    ratio-1.0 allowance, ``committed`` what placed VMs reserved. The
    floor at zero keeps committed tokens irrevocable, so ``committed +
    free == max(base * ratio, committed)`` through any ratio walk."""
    return np.maximum(np.asarray(base_pool) * ratio - np.asarray(committed),
                      0)


# --- torch twin -----------------------------------------------------------

def init_adaptive(cfg: AdaptiveConfig, n_chassis: int, batch_shape=(),
                  dtype=torch.float32, device=None) -> AdaptiveState:
    """`init_adaptive_np` as tensors on `device` (None: the card)."""
    device = resolve_device(device)
    shape_c = tuple(batch_shape) + (n_chassis,)
    return AdaptiveState(
        util=torch.zeros(shape_c + (cfg.window,), dtype=dtype,
                         device=device),
        count=torch.zeros(shape_c, dtype=torch.int32, device=device),
        head=torch.zeros(shape_c, dtype=torch.int32, device=device),
        ratio=torch.ones(tuple(batch_shape), dtype=dtype, device=device),
        ratchets=torch.zeros(tuple(batch_shape), dtype=torch.int32,
                             device=device),
        backoffs=torch.zeros(tuple(batch_shape), dtype=torch.int32,
                             device=device))


def state_to_torch(st: AdaptiveState, device) -> AdaptiveState:
    """An oracle state as tensors on `device` (dtypes kept)."""
    return AdaptiveState(*(torch.as_tensor(np.asarray(a), device=device)
                           for a in st))


def _util_from_power(cfg: AdaptiveConfig, rho_lv: torch.Tensor,
                     power_w: torch.Tensor) -> torch.Tensor:
    """`_util_from_power_np` on tensors; it divides by a tensor."""
    rho = rho_lv.sum(-1)
    dyn = torch.clamp(power_w - _scalar(cfg.static_w, power_w.dtype), min=0)
    pos = rho > 0
    return torch.where(
        pos, dyn / (_scalar(cfg.p_dyn_per_core, rho.dtype)
                    * torch.where(pos, rho, 1.0)), 0.0)


def adaptive_step(cfg: AdaptiveConfig, st: AdaptiveState,
                  rho_lv: torch.Tensor, power_w, mask):
    """`adaptive_step_np` on tensors, in `rho_lv`'s dtype and on its
    device: the ring gathers take int64 indices, the percentile indices
    truncate a product of dtype-rounded factors, and the flip rate and
    stable share divide by tensors."""
    dtype, dev = rho_lv.dtype, rho_lv.device
    W = cfg.window
    power_w = torch.as_tensor(power_w, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    u_new = _util_from_power(cfg, rho_lv, power_w).to(dtype)

    slot = torch.arange(W, dtype=torch.int32, device=dev)
    write = mask[..., None] & (slot == st.head[..., None])
    util = torch.where(write, u_new[..., None], st.util.to(dtype))
    count = torch.where(mask, torch.clamp(st.count + 1, max=W), st.count)
    head = torch.where(mask, (st.head + 1) % W, st.head)

    idx = (head[..., None] + slot) % W
    chrono = torch.gather(util, -1, idx.long())
    valid = slot >= (W - count)[..., None]

    svals = torch.sort(torch.where(valid, chrono, torch.inf), dim=-1).values
    nm1 = torch.clamp(count - 1, min=0).to(dtype)
    i_lo = (_scalar(cfg.spread_q_lo, dtype) * nm1).to(torch.int32)
    i_hi = (_scalar(cfg.spread_q_hi, dtype) * nm1).to(torch.int32)
    q_lo = torch.gather(svals, -1, i_lo.long()[..., None])[..., 0]
    q_hi = torch.gather(svals, -1, i_hi.long()[..., None])[..., 0]
    q_lo = torch.where(torch.isfinite(q_lo), q_lo, 0.0)
    q_hi = torch.where(torch.isfinite(q_hi), q_hi, 0.0)
    spread = q_hi - q_lo

    d = torch.where(valid[..., :-1], chrono[..., 1:] - chrono[..., :-1], 0.0)
    flips = ((torch.sign(d[..., 1:]) * torch.sign(d[..., :-1])) < 0).to(
        torch.int32).sum(-1)
    flip_rate = flips.to(dtype) / torch.clamp(count - 2, min=1).to(dtype)

    latest = chrono[..., -1]
    hot_c = (count >= 1) & (latest > _scalar(cfg.hot_util, dtype))
    known = count >= cfg.min_history
    stable = known & (spread <= _scalar(cfg.spread_thresh, dtype)) \
        & (flip_rate <= _scalar(cfg.flip_thresh, dtype)) & ~hot_c

    n_known = known.to(torch.int32).sum(-1)
    n_stable = stable.to(torch.int32).sum(-1)
    hot = hot_c.to(torch.int32).sum(-1) > 0
    frac = n_stable.to(dtype) / torch.clamp(n_known, min=1).to(dtype)
    ratchet = (n_known > 0) & ~hot \
        & (frac >= _scalar(cfg.ratchet_quorum, dtype))
    backoff = hot | ((n_known > 0)
                     & (frac < _scalar(cfg.backoff_quorum, dtype)))
    ratio = torch.clamp(
        st.ratio.to(dtype)
        + _scalar(cfg.step_up, dtype) * ratchet.to(dtype)
        - _scalar(cfg.step_down, dtype) * backoff.to(dtype),
        min=_scalar(cfg.ratio_min, dtype), max=_scalar(cfg.ratio_max, dtype))

    st2 = AdaptiveState(util=util, count=count, head=head, ratio=ratio,
                        ratchets=st.ratchets + ratchet.to(torch.int32),
                        backoffs=st.backoffs + backoff.to(torch.int32))
    return st2, AdaptiveOutputs(
        ratio=ratio, stable_frac=frac, n_known=n_known, n_stable=n_stable,
        ratchet=ratchet, backoff=backoff, hot=hot, spread=spread,
        flip_rate=flip_rate, stable=stable)


# --- host helpers, either form ---------------------------------------------

def gate_ratio_on_stale(cfg: AdaptiveConfig, ratio, stale: bool):
    """The applied ratio, clamped to ``cfg.ratio_min`` while the
    prediction scorecard reports a stale model and passed through
    otherwise. The controller state is never rewritten, so the integrated
    ratio resumes once the model scores fresh again. Takes a numpy array
    or a tensor, scalar or batched."""
    if not stale:
        return ratio
    if torch.is_tensor(ratio):
        return torch.clamp(ratio, max=_scalar(cfg.ratio_min, ratio.dtype))
    ratio = np.asarray(ratio)
    return np.minimum(ratio, np.asarray(cfg.ratio_min, dtype=ratio.dtype))


def decision_reason(before_ratio: float, out_ratio: float, n_known: int,
                    ratchet: bool, backoff: bool, hot: bool) -> int:
    """Index into `REASON_NAMES` for one scalar controller decision."""
    if backoff:
        if out_ratio == before_ratio:
            return 6                       # backoff_floor
        return 4 if hot else 5             # backoff_hot / backoff_quorum
    if ratchet:
        return 3 if out_ratio == before_ratio else 2
    return 0 if n_known == 0 else 1        # hold_no_history / hold_band
