"""Fleet-scale simulation engine: the capping dynamics of many chassis at
once, the counterpart of `repro.sim.fleet`.

The paper's headline results (Figs 4-6, Table IV) need capping dynamics
and policy sweeps over a whole fleet. The substrate is dense and
fixed-shape:

  * `run_fleet(..., backend='torch')` — a Python loop over 200 ms time
    steps of `core.fleet_dynamics.fleet_step` on `device`, with the run
    axis (chassis, scenario grid points) as a batch dim of every tensor.
    Per-step outputs go into preallocated device tensors and come back to
    the host in one copy at the end. Figs 4-6 are slices of a fleet run.
  * `run_fleet(..., backend='numpy')` — the validation oracle: the
    reference's numpy arithmetic (`fleet_step_np`), stepped one chassis
    at a time, array-equal to `repro.sim.fleet`'s numpy backend.
  * `sweep_scenarios` — one batched run over a grid of chassis budgets,
    offered-load scales and NUF frequency floors, for Table IV-style
    frontiers. Heterogeneous chassis layouts batch the layout arrays
    instead — see `run_fleet_layouts`.

Per-VM UF capacity is a gather of each VM's cores followed by a sum over
them (`_uf_gather`), not a product against the 0/1 compaction matrix:
the sum stays in float32 on any setting of TF32, and a fixed-shape
reduction sums in the same order on every run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.fleet_dynamics import (ALERT_FRACTION, ALERT_MARGIN_W,
                                             FREQ_TABLE, POLL_INTERVAL_S,
                                             ControlParams, RunParams,
                                             fleet_step, fleet_step_np,
                                             init_state, init_state_np)
from repro_torch.core.power_model import (F_MAX, F_MIN, N_PSTATES,
                                          ServerPowerModel)
from repro_torch.device import resolve_device

_F32 = np.float32


# --- workload specification -------------------------------------------------

@dataclass
class VMSpec:
    n_cores: int
    is_uf: bool
    #: offered load as a fraction of the VM's full-frequency capacity
    load: float = 0.75


@dataclass
class ServerSpec:
    vms: list                       # list[VMSpec]; sum cores <= n_cores
    n_cores: int = 40


def _uf_load_trace(rng, n_steps: int, base: float) -> np.ndarray:
    """Fluctuating interactive load (paper Fig. 4 power wiggles)."""
    wave = 0.12 * np.sin(np.linspace(0, 6 * np.pi, n_steps))
    slow = 0.06 * np.sin(np.linspace(0, 1.5 * np.pi, n_steps))
    noise = rng.normal(0, 0.03, n_steps)
    return np.clip(base + wave + slow + noise, 0.05, 1.2)


# --- padded fleet layout ----------------------------------------------------

class LayoutArrays(NamedTuple):
    """The per-chassis arrays the engines consume (numpy). Shared across
    a homogeneous fleet or batched with a leading B axis for
    heterogeneous placements (see `stack_layouts`). Per-step UF capacity
    reads only the UF cores (uf_core_idx/uf_compact); the NUF work
    integral is a raw per-core frequency sum reduced by nuf_onehot once
    after the run."""
    uf_mask: Any        # (S, C) bool
    nuf_core: Any       # (S, C) bool
    active: Any         # (S, C) bool or None (= all cores real)
    uf_id: Any          # (S*C,) i32, owning UF VM (Vu = unowned)
    uf_core_idx: Any    # (Ku,) i32, flat indices of UF cores (0-padded)
    uf_compact: Any     # (Ku, Vu) f32, UF-core -> VM membership
    uf_cores: Any       # (Vu,) f32
    nuf_onehot: Any     # (Vn, S*C) f32
    nuf_cores: Any      # (Vn,) f32


@dataclass(frozen=True)
class FleetLayout:
    """Dense, fixed-shape view of one chassis' VM placement.

    Core-level masks are (S, C); VM-level reductions are one-hot
    matrices over the flattened (S*C,) core axis. VM slots beyond the
    real count are padding (`*_valid` False, zero one-hot rows)."""
    n_servers: int
    n_cores: int
    uf_mask: np.ndarray        # (S, C) bool — cores of user-facing VMs
    nuf_core: np.ndarray       # (S, C) bool — cores of batch VMs
    active: np.ndarray         # (S, C) bool — core exists (not padding)
    uf_onehot: np.ndarray      # (Vu, S*C) f32 — membership of UF VM v
    uf_cores: np.ndarray       # (Vu,) f32
    uf_loads: np.ndarray       # (Vu,) f32 — base offered load
    uf_valid: np.ndarray       # (Vu,) bool
    nuf_onehot: np.ndarray     # (Vn, S*C) f32
    nuf_cores: np.ndarray      # (Vn,) f32
    nuf_valid: np.ndarray      # (Vn,) bool
    uf_id: np.ndarray          # (S*C,) i32 — owning UF VM, Vu = none
    nuf_id: np.ndarray         # (S*C,) i32 — owning NUF VM, Vn = none

    def arrays(self, pad_uf_cores_to: int = 0) -> LayoutArrays:
        """The engine's arrays. `active` is None when every core is real
        — the transition then skips all padding masks."""
        n_uf = len(self.uf_valid)
        idx = np.nonzero(self.uf_id < n_uf)[0]
        ku = max(len(idx), pad_uf_cores_to, 1)
        core_idx = np.zeros(ku, np.int32)
        core_idx[:len(idx)] = idx
        compact = np.zeros((ku, n_uf), _F32)
        compact[np.arange(len(idx)), self.uf_id[idx]] = 1.0
        return LayoutArrays(self.uf_mask, self.nuf_core,
                            None if self.active.all() else self.active,
                            self.uf_id, core_idx, compact, self.uf_cores,
                            self.nuf_onehot, self.nuf_cores)


def build_layout(specs: list, pad_uf_to: int = 0, pad_nuf_to: int = 0,
                 pad_cores_to: int = 0) -> FleetLayout:
    """Pack a list[ServerSpec] into padded fleet arrays. VM walk order
    (server-major, then VM) matches the seed simulator, so load traces
    drawn per-VM consume the rng stream identically."""
    n_servers = len(specs)
    n_cores = max(pad_cores_to, max(s.n_cores for s in specs))
    uf_mask = np.zeros((n_servers, n_cores), bool)
    nuf_core = np.zeros((n_servers, n_cores), bool)
    active = np.zeros((n_servers, n_cores), bool)
    uf_members, uf_loads, nuf_members = [], [], []
    for si, spec in enumerate(specs):
        active[si, :spec.n_cores] = True
        c0 = 0
        for vm in spec.vms:
            cores = np.zeros((n_servers, n_cores), bool)
            cores[si, c0:c0 + vm.n_cores] = True
            if vm.is_uf:
                uf_mask |= cores
                uf_members.append(cores.ravel())
                uf_loads.append(vm.load)
            else:
                nuf_core |= cores
                nuf_members.append(cores.ravel())
            c0 += vm.n_cores

    def _pack(members, pad_to):
        n = max(len(members), pad_to, 1)
        onehot = np.zeros((n, n_servers * n_cores), _F32)
        valid = np.zeros(n, bool)
        for i, m in enumerate(members):
            onehot[i] = m
            valid[i] = True
        return onehot, onehot.sum(-1).astype(_F32), valid

    uf_onehot, uf_cores, uf_valid = _pack(uf_members, pad_uf_to)
    nuf_onehot, nuf_cores, nuf_valid = _pack(nuf_members, pad_nuf_to)
    loads = np.zeros(len(uf_valid), _F32)
    loads[:len(uf_loads)] = uf_loads

    def _ids(members, n_slots):
        ids = np.full(n_servers * n_cores, n_slots, np.int32)
        for i, m in enumerate(members):
            ids[m] = i
        return ids

    return FleetLayout(n_servers, n_cores, uf_mask, nuf_core, active,
                       uf_onehot, uf_cores, loads, uf_valid,
                       nuf_onehot, nuf_cores, nuf_valid,
                       _ids(uf_members, len(uf_valid)),
                       _ids(nuf_members, len(nuf_valid)))


def build_uf_traces(layout: FleetLayout, n_steps: int, seed: int,
                    load_scale: float = 1.0) -> np.ndarray:
    """(n_steps, Vu) offered-load traces, drawn in the seed's VM order."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n_steps, len(layout.uf_valid)), _F32)
    for v in range(len(layout.uf_valid)):
        if layout.uf_valid[v]:
            out[:, v] = _uf_load_trace(rng, n_steps, layout.uf_loads[v])
    return out * _F32(load_scale)


def stack_layouts(layouts: list) -> LayoutArrays:
    """Batch heterogeneous chassis layouts (leading axis B). Pads the
    compact UF-core axis to the largest chassis; VM axes must already
    share shapes (build with pad_uf_to/pad_nuf_to)."""
    ku = max(int((lo.uf_id < len(lo.uf_valid)).sum()) for lo in layouts)
    # `active` collapses to None only if EVERY chassis is fully active
    active = None if all(lo.active.all() for lo in layouts) \
        else np.stack([lo.active for lo in layouts])
    arrs = [lo.arrays(pad_uf_cores_to=ku)._replace(active=None)
            for lo in layouts]
    return LayoutArrays(*(np.stack(x) if x[0] is not None else None
                          for x in zip(*arrs)))._replace(active=active)


# --- the per-step workload/application model: numpy oracle ------------------

def _offered_util(la: LayoutArrays, trace_t, freq):
    """Per-core offered utilization of one chassis: batch saturates its
    cores; the interactive load rises when cores are slowed (same work,
    less capacity): util = min(1, load / f)."""
    pad = np.concatenate([trace_t, np.zeros(1, trace_t.dtype)])
    load_core = pad[la.uf_id].reshape(freq.shape)
    util = np.where(la.uf_mask,
                    np.minimum(load_core / np.maximum(freq, _F32(1e-3)),
                               _F32(1.0)), _F32(0.0))
    return np.where(la.nuf_core, _F32(1.0), util)


def _app_update(la: LayoutArrays, trace_t, freq, backlog, freq_sum, dt):
    """Fluid-queue UF app + fixed-work NUF app (paper §IV-C), one
    chassis. Returns updated carries + per-step latency and the minimum
    NUF core frequency. The NUF integral carry is the raw per-core
    frequency sum; callers reduce it per-VM after the run."""
    freq_flat = freq.reshape(-1)
    cap = freq_flat[la.uf_core_idx] @ la.uf_compact     # (Vu,)
    lam = trace_t * la.uf_cores
    backlog = np.clip(backlog + (lam - cap) * _F32(dt), _F32(0.0), cap)
    # closed-loop client pool: bounded in-flight work (backlog <= cap);
    # stationary-queue term capped at rho = 0.9
    meanf = cap / np.maximum(la.uf_cores, _F32(1.0))
    service = _F32(1.0) / np.maximum(meanf, _F32(1e-6))
    rho = np.minimum(lam / np.maximum(cap, _F32(1e-6)), _F32(0.9))
    latency = service * (_F32(1.0) + rho / (_F32(1.0) - rho) * _F32(0.15)) \
        + backlog / np.maximum(cap, _F32(1e-6))
    freq_sum = freq_sum + freq_flat
    min_nuf = np.min(np.where(la.nuf_core, freq, _F32(F_MAX)),
                     axis=(-2, -1))
    return backlog, freq_sum, latency, min_nuf


def _run_numpy_one(cp, la, sc, traces):
    """One chassis, looped over time — the seed's execution model."""
    S, C = la.uf_mask.shape
    st = init_state_np((), S, C)
    rp = RunParams(sc["server_budget"], sc["target"], sc["alert"],
                   sc["min_pstate"], la.uf_mask, la.active)
    n_steps = traces.shape[0]
    backlog = np.zeros(la.uf_cores.shape[0], _F32)
    freq_sum = np.zeros(S * C, _F32)
    power = np.zeros(n_steps, _F32)
    min_nuf = np.zeros(n_steps, _F32)
    lat = np.zeros((n_steps, la.uf_cores.shape[0]), _F32)
    rapl_cnt = np.zeros(n_steps, np.int32)
    alert = np.zeros(n_steps, bool)
    for t in range(n_steps):
        util = _offered_util(la, traces[t], st.freq)
        st, outs = fleet_step_np(cp, rp, st, util)
        backlog, freq_sum, lat_t, mn = _app_update(
            la, traces[t], st.freq, backlog, freq_sum, cp.dt)
        power[t] = outs.chassis_power_w
        min_nuf[t] = mn
        lat[t] = lat_t
        rapl_cnt[t] = outs.rapl.sum()
        alert[t] = outs.alert
    integ = (freq_sum @ la.nuf_onehot.T) * _F32(cp.dt)
    return power, min_nuf, lat, rapl_cnt, alert, integ


def _numpy_engine(cp, la: LayoutArrays, sc: dict, traces, shared: bool):
    """The oracle over the run axis, one chassis at a time."""
    def layout(b):
        return la if shared else LayoutArrays(
            *(None if a is None else a[b] for a in la))
    outs = [_run_numpy_one(cp, layout(b), {k: v[b] for k, v in sc.items()},
                           traces[b]) for b in range(traces.shape[0])]
    return tuple(np.stack(x) for x in zip(*outs))


# --- torch engine: a loop over time, the run axis as a batch dim -----------

def _uf_gather(la: LayoutArrays, shared: bool) -> np.ndarray:
    """(Vu, W) or (B, Vu, W) flat core indices of each UF VM, padded with
    S*C (a slot that holds frequency 0): capacity = a gather and a sum
    over W, the compaction product written as the sum it computes."""
    def one(core_idx, compact, n_flat):
        members = [core_idx[compact[:, v] > 0]
                   for v in range(compact.shape[1])]
        width = max(1, max(len(m) for m in members))
        out = np.full((len(members), width), n_flat, np.int64)
        for v, m in enumerate(members):
            out[v, :len(m)] = m
        return out, width
    n_flat = la.uf_id.shape[-1]
    if shared:
        return one(la.uf_core_idx, la.uf_compact, n_flat)[0]
    parts = [one(la.uf_core_idx[b], la.uf_compact[b], n_flat)
             for b in range(la.uf_compact.shape[0])]
    width = max(w for _, w in parts)
    return np.stack([np.pad(p, ((0, 0), (0, width - w)),
                            constant_values=n_flat) for p, w in parts])


def _torch_engine(cp, la: LayoutArrays, sc: dict, traces, shared: bool,
                  device):
    """The torch twin over the run axis B on `device`: every tensor
    carries B as its leading dim (the layout too when not `shared`).
    Returns host numpy (power, min_nuf, lat, rapl_cnt, alert, freq_sum)
    after one copy at the end."""
    dev = resolve_device(device)
    B, T, Vu = traces.shape
    S, C = la.uf_mask.shape[-2:]

    def t(a, dtype=None):
        return None if a is None else torch.tensor(np.asarray(a),
                                                   dtype=dtype, device=dev)
    uf_mask, nuf_core, active = t(la.uf_mask), t(la.nuf_core), t(la.active)
    uf_id = t(la.uf_id, torch.int64).expand(B, S * C)
    uf_idx = t(_uf_gather(la, shared))
    if shared:
        uf_idx = uf_idx.expand(B, *uf_idx.shape)
    uf_idx = uf_idx.reshape(B, -1)
    uf_cores = t(la.uf_cores)
    rp = RunParams(t(sc["server_budget"]), t(sc["target"]), t(sc["alert"]),
                   t(sc["min_pstate"]), uf_mask, active)
    trace_dev = t(traces)                                    # (B, T, Vu)
    pad = torch.zeros(B, Vu + 1, dtype=torch.float32, device=dev)
    st = init_state((B,), S, C, dev)
    backlog = torch.zeros(B, Vu, dtype=torch.float32, device=dev)
    freq_sum = torch.zeros(B, S * C, dtype=torch.float32, device=dev)
    flat = torch.zeros(B, S * C + 1, dtype=torch.float32, device=dev)
    power = torch.empty(T, B, dtype=torch.float32, device=dev)
    min_nuf = torch.empty(T, B, dtype=torch.float32, device=dev)
    lat = torch.empty(T, B, Vu, dtype=torch.float32, device=dev)
    rapl_cnt = torch.empty(T, B, dtype=torch.int32, device=dev)
    alert = torch.empty(T, B, dtype=torch.bool, device=dev)
    for step in range(T):
        trace_t = trace_dev[:, step]
        # _offered_util
        pad[:, :Vu] = trace_t
        load_core = torch.gather(pad, 1, uf_id).view(B, S, C)
        util = torch.where(uf_mask, torch.clamp(
            load_core / torch.clamp(st.freq, min=1e-3), max=1.0), 0.0)
        util = torch.where(nuf_core, 1.0, util)
        st, outs = fleet_step(cp, rp, st, util)
        # _app_update
        freq_flat = st.freq.view(B, S * C)
        flat[:, :S * C] = freq_flat
        cap = torch.gather(flat, 1, uf_idx).view(B, Vu, -1).sum(-1)
        lam = trace_t * uf_cores
        backlog = torch.minimum(
            torch.clamp(backlog + (lam - cap) * cp.dt, min=0.0), cap)
        meanf = cap / torch.clamp(uf_cores, min=1.0)
        service = 1.0 / torch.clamp(meanf, min=1e-6)
        rho = torch.clamp(lam / torch.clamp(cap, min=1e-6), max=0.9)
        lat[step] = service * (1.0 + rho / (1.0 - rho) * 0.15) \
            + backlog / torch.clamp(cap, min=1e-6)
        freq_sum += freq_flat
        min_nuf[step] = torch.where(nuf_core, st.freq, F_MAX).amin((-2, -1))
        power[step] = outs.chassis_power_w
        rapl_cnt[step] = outs.rapl.sum(-1)
        alert[step] = outs.alert
    host = [x.cpu().numpy() for x in (power, min_nuf, lat, rapl_cnt, alert)]
    return tuple(np.moveaxis(x, 0, 1) for x in host) \
        + (freq_sum.cpu().numpy(),)


def _engine(backend: str, cp, la: LayoutArrays, sc: dict, traces,
            shared: bool, device):
    """(power, min_nuf, lat, rapl_cnt, alert, integ) over the run axis
    from the chosen backend; the NUF integral is reduced on the host."""
    if backend == "numpy":
        return _numpy_engine(cp, la, sc, traces, shared)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}; expected 'torch' "
                         "or 'numpy'")
    *outs, freq_sum = _torch_engine(cp, la, sc, traces, shared, device)
    onehot_t = np.swapaxes(la.nuf_onehot, -1, -2)
    integ = (freq_sum[:, None, :] @ onehot_t)[:, 0] * _F32(cp.dt)
    return (*outs, integ)


def _scalars(budget_w, n_servers: int, min_pstate) -> dict:
    """Per-run control scalars from a chassis budget (inf = uncapped)."""
    budget = np.asarray(budget_w, _F32)
    server_b = budget / _F32(n_servers)
    return {"server_budget": server_b,
            "target": server_b - _F32(ALERT_MARGIN_W),
            "alert": budget * _F32(ALERT_FRACTION),
            "min_pstate": np.asarray(min_pstate, np.int32)}


# --- results ----------------------------------------------------------------

@dataclass
class SimResult:
    power_w: np.ndarray                 # (n_steps,) chassis draw
    min_nuf_freq: np.ndarray            # (n_steps,)
    uf_p95_latency: float               # mean across UF VMs
    nuf_slowdown: float                 # mean across NUF VMs (>= 1.0)
    rapl_engaged_frac: float


@dataclass
class FleetResult:
    """Batched over the run axis B (chassis / scenario grid points)."""
    power_w: np.ndarray                 # (B, T)
    min_nuf_freq: np.ndarray            # (B, T)
    uf_latency: np.ndarray              # (B, T, Vu) per-step, padded VMs 0
    alert_frac: np.ndarray              # (B,)
    rapl_engaged_frac: np.ndarray       # (B,)
    uf_p95_latency: np.ndarray          # (B,)
    nuf_slowdown: np.ndarray            # (B,)

    def chassis(self, b: int) -> SimResult:
        return SimResult(self.power_w[b], self.min_nuf_freq[b],
                         float(self.uf_p95_latency[b]),
                         float(self.nuf_slowdown[b]),
                         float(self.rapl_engaged_frac[b]))


def _aggregate(layout_valid, nuf_cores, duration_s, power, min_nuf, lat,
               rapl_cnt, alert, nuf_integ, n_servers) -> FleetResult:
    uf_valid, nuf_valid = layout_valid
    lat = lat * uf_valid.astype(lat.dtype)      # zero padded VM columns
    n_steps = power.shape[-1]
    if uf_valid.any():
        p95 = np.percentile(lat[..., uf_valid], 95, axis=1)   # (B, Vu')
        uf_p95 = p95.mean(-1)
    else:
        uf_p95 = np.zeros(power.shape[0])
    if nuf_valid.any():
        nominal = nuf_cores[nuf_valid] * F_MAX * duration_s
        slow = nominal / np.maximum(nuf_integ[..., nuf_valid], 1e-9)
        nuf_slow = slow.mean(-1)
    else:
        nuf_slow = np.ones(power.shape[0])
    return FleetResult(
        power_w=power, min_nuf_freq=min_nuf, uf_latency=lat,
        alert_frac=alert.mean(-1),
        rapl_engaged_frac=rapl_cnt.sum(-1) / (n_steps * n_servers),
        uf_p95_latency=uf_p95, nuf_slowdown=nuf_slow)


# --- public API -------------------------------------------------------------

def run_fleet(specs: list, budgets_w, mode: str,
              duration_s: float = 600.0, seed=0,
              model: ServerPowerModel | None = None,
              backend: str = "torch", load_scale=1.0, min_pstate=None,
              layout: FleetLayout | None = None,
              traces: np.ndarray | None = None,
              device=None) -> FleetResult:
    """Simulate a fleet of identical-layout chassis under per-chassis
    budgets. `budgets_w`: None (uncapped), scalar, or (B,) array — the
    run axis. `seed`: int (all chassis share one trace draw) or (B,)
    array (independent chassis). `backend`: 'torch' (the engine on
    `device`; None means the card, and raises without one) or 'numpy'
    (the oracle). Returns a batched FleetResult."""
    model = model or ServerPowerModel()
    cp = ControlParams.from_model(model, mode=mode)
    layout = layout or build_layout(specs)
    n_steps = int(duration_s / POLL_INTERVAL_S)

    budgets = np.asarray(
        [np.inf] if budgets_w is None else budgets_w, _F32).reshape(-1)
    budgets = np.where(np.isfinite(budgets), budgets, np.inf)
    n_runs = len(budgets)

    if traces is None:
        seeds = np.broadcast_to(np.asarray(seed), (n_runs,))
        scales = np.broadcast_to(np.asarray(load_scale, _F32), (n_runs,))
        if np.all(seeds == seeds[0]):
            base = build_uf_traces(layout, n_steps, int(seeds[0]))
            traces = base[None] * scales[:, None, None]
        else:
            traces = np.stack([
                build_uf_traces(layout, n_steps, int(s), float(sc))
                for s, sc in zip(seeds, scales)])
    traces = np.asarray(traces, _F32)
    if traces.ndim == 2:
        traces = np.broadcast_to(traces[None], (n_runs,) + traces.shape)

    minp = N_PSTATES - 1 if min_pstate is None else min_pstate
    sc = _scalars(budgets, layout.n_servers,
                  np.broadcast_to(np.asarray(minp, np.int32), (n_runs,)))
    outs = _engine(backend, cp, layout.arrays(), sc, traces, True, device)
    return _aggregate((layout.uf_valid, layout.nuf_valid),
                      layout.nuf_cores, duration_s, *outs,
                      layout.n_servers)


def run_fleet_layouts(layouts_arrays, uf_valid, nuf_valid, nuf_cores,
                      budgets_w, mode: str, traces,
                      model: ServerPowerModel | None = None,
                      duration_s: float | None = None,
                      backend: str = "torch", device=None) -> FleetResult:
    """Heterogeneous fleet: every chassis brings its own (padded,
    shape-identical) layout arrays — batched with leading axis B. Used
    by the scheduler simulation to evaluate the capping dynamics of the
    placements it actually produced. `backend`/`device` as `run_fleet`."""
    model = model or ServerPowerModel()
    cp = ControlParams.from_model(model, mode=mode)
    n_runs, n_steps = traces.shape[0], traces.shape[1]
    layouts_arrays = LayoutArrays(*layouts_arrays)
    n_servers = layouts_arrays.uf_mask.shape[1]
    if duration_s is None:
        duration_s = n_steps * POLL_INTERVAL_S
    budgets = np.asarray(budgets_w, _F32).reshape(-1)
    minp = np.full(n_runs, N_PSTATES - 1, np.int32)
    sc = _scalars(np.broadcast_to(budgets, (n_runs,)), n_servers, minp)
    traces = np.asarray(traces, _F32)
    power, min_nuf, lat, rapl_cnt, alert, integ = _engine(
        backend, cp, layouts_arrays, sc, traces, False, device)
    # per-chassis VM validity differs: aggregate row-wise
    lat = lat * uf_valid[:, None, :].astype(lat.dtype)
    uf_p95 = np.zeros(n_runs)
    nuf_slow = np.ones(n_runs)
    for b in range(n_runs):
        if uf_valid[b].any():
            uf_p95[b] = np.percentile(lat[b][:, uf_valid[b]], 95,
                                      axis=0).mean()
        if nuf_valid[b].any():
            nominal = nuf_cores[b][nuf_valid[b]] * F_MAX * duration_s
            nuf_slow[b] = (nominal / np.maximum(
                integ[b][nuf_valid[b]], 1e-9)).mean()
    return FleetResult(power, min_nuf, lat, alert.mean(-1),
                       rapl_cnt.sum(-1) / (n_steps * n_servers),
                       uf_p95, nuf_slow)


# --- scenario sweeps (Table IV-style frontiers) -----------------------------

def fmin_to_pstate(fmin: float) -> int:
    """Nearest p-state index for a frequency floor (FREQ_TABLE is
    descending f_max..f_min)."""
    return int(np.argmin(np.abs(FREQ_TABLE - np.float32(fmin))))


def sweep_scenarios(specs: list, budgets_w, load_scales=(1.0,),
                    fmin_nuf=(F_MIN,), mode: str = "per_vm",
                    duration_s: float = 120.0, seed: int = 0,
                    model: ServerPowerModel | None = None,
                    backend: str = "torch",
                    include_uncapped: bool = True, device=None) -> dict:
    """One batched run over the (budget x load-scale x NUF-floor) grid.
    Returns metric arrays of shape (n_budgets[+1], n_loads, n_floors);
    index 0 of the budget axis is the uncapped baseline when
    `include_uncapped` (for latency-impact ratios)."""
    budgets = list(np.asarray(budgets_w, np.float64).reshape(-1))
    if include_uncapped:
        budgets = [np.inf] + budgets
    shape = (len(budgets), len(load_scales), len(fmin_nuf))
    bb, ll, ff = np.meshgrid(
        np.asarray(budgets, _F32), np.asarray(load_scales, _F32),
        np.asarray([fmin_to_pstate(f) for f in fmin_nuf], np.int32),
        indexing="ij")
    res = run_fleet(specs, bb.ravel(), mode, duration_s, seed, model,
                    backend, load_scale=ll.ravel(),
                    min_pstate=ff.ravel(), device=device)
    out = {"budgets_w": np.asarray(budgets),
           "load_scales": np.asarray(load_scales),
           "fmin_nuf": np.asarray(fmin_nuf)}
    for name in ("uf_p95_latency", "nuf_slowdown", "rapl_engaged_frac",
                 "alert_frac"):
        out[name] = getattr(res, name).reshape(shape)
    out["power_max_w"] = res.power_w.max(-1).reshape(shape)
    if include_uncapped:
        base = out["uf_p95_latency"][:1]
        out["uf_latency_ratio"] = out["uf_p95_latency"] \
            / np.maximum(base, 1e-9)
    return out


def frontier(sweep: dict, provisioned_w: float,
             max_uf_latency_ratio: float = 1.05,
             max_rapl_frac: float = 0.001) -> dict:
    """Table IV-style frontier: for each (load-scale, NUF-floor) cell,
    the lowest budget whose measured UF impact and RAPL engagement stay
    within tolerance, and the recovered provisioned-power fraction."""
    if "uf_latency_ratio" not in sweep:
        raise ValueError("sweep must include the uncapped baseline")
    ok = (sweep["uf_latency_ratio"] <= max_uf_latency_ratio) \
        & (sweep["rapl_engaged_frac"] <= max_rapl_frac)
    budgets = sweep["budgets_w"]                       # descending walk
    best = np.full(ok.shape[1:], np.inf)
    for i in range(ok.shape[0]):
        best = np.where(ok[i] & np.isfinite(budgets[i]),
                        np.minimum(best, budgets[i]), best)
    feasible = np.isfinite(best)
    oversub = np.where(feasible, 1.0 - best / provisioned_w, 0.0)
    return {"budget_w": np.where(feasible, best, provisioned_w),
            "oversubscription": oversub, "feasible": feasible}
