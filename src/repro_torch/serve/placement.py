"""Algorithm-1 placement with power admission (serve-pipeline stages 3-4),
the torch counterpart of `repro.serve.placement`.

`place_batch` is the tensor twin of `SchedulerPolicy.choose` +
`ClusterState.place`, in the direct rank form: it walks an arrival
micro-batch in order (each placement sees the earlier ones, as in the
event-driven scheduler) and for each arrival scores every server at
once, ranks the feasible subset under each preference rule with one
stable sort, weights each rank `1 - r/(n-1)` (`n == 1` -> 1), and takes
the first argmax by server index. The JAX reference maintains the rank
orders incrementally instead, because sorting inside `lax.scan` is slow
on XLA's CPU backend; the decisions are the same.

Arithmetic follows the state dtype: float32 on the serving path, and in
float64 the decisions are identical to the numpy oracle. Divisions are
by device tensors, never by Python scalars: CUDA divides by a scalar as
a multiply by its reciprocal, which could move a score by one bit
against the CPU.

A placement that would push its chassis over any axis of its (C, R)
admission ceiling is rejected with FAIL_POWER before it mutates the
state (`serve/admission.py`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.placement import ClusterState, SchedulerPolicy
from repro_torch.core.resources import N_RESOURCES
from repro_torch.device import resolve_device

#: `place_batch` outcome codes (in the returned server array).
FAIL_CAPACITY = -1      # no feasible server (deployment failure)
FAIL_POWER = -2         # a chassis resource ceiling rejected (any axis)
FAIL_TOKENS = -3        # shard's token pool exhausted (sharded serving)


class DeviceClusterState(NamedTuple):
    """Tensor mirror of `core.placement.ClusterState`'s aggregates over
    the (watts, cores, GB) resource ledger: `res_peak` tracks committed
    (rho, cores, GB) per chassis, axis 0 being `rho_peak`."""
    free_cores: torch.Tensor     # (S,)
    gamma_uf: torch.Tensor       # (S,)
    gamma_nuf: torch.Tensor      # (S,)
    res_peak: torch.Tensor       # (C, R) committed (rho, cores, GB)
    rho_max: torch.Tensor        # (C,)
    chassis_of: torch.Tensor     # (S,) int64

    @property
    def rho_peak(self) -> torch.Tensor:
        """(C,) committed sum(p95*cores) — the watts axis of the ledger."""
        return self.res_peak[..., 0]

    @property
    def n_servers(self) -> int:
        return self.free_cores.shape[0]


def device_state(state: ClusterState, dtype=torch.float32, device=None,
                 mem_gb=None) -> DeviceClusterState:
    """Mirror a host `ClusterState` onto `device` in `dtype` (float32 to
    serve, float64 to hold decisions against the numpy oracle). The
    cores axis of `res_peak` is derived from the per-server free cores,
    the GB axis is `mem_gb` ((C,) committed GB; zeros when None)."""
    dev = resolve_device(device)
    chassis_of = np.asarray(state.chassis_of_server, np.int64)
    used = float(state.cores_per_server) - np.asarray(state.free_cores,
                                                      np.float64)
    cores_comm = np.bincount(chassis_of, weights=used,
                             minlength=state.n_chassis)
    mem = np.zeros(state.n_chassis) if mem_gb is None \
        else np.asarray(mem_gb, np.float64)
    res_peak = np.stack([np.asarray(state.rho_peak, np.float64),
                         cores_comm, mem], axis=-1)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    return DeviceClusterState(t(state.free_cores), t(state.gamma_uf),
                              t(state.gamma_nuf), t(res_peak),
                              t(state.rho_max), t(chassis_of, torch.int64))


def fresh_state(n_servers: int, cores_per_server: int, chassis_of,
                dtype=torch.float32, device=None) -> DeviceClusterState:
    """State of an empty cluster (every core free, nothing committed)
    with the given server -> chassis layout."""
    chassis_of = np.asarray(chassis_of)
    return device_state(ClusterState(
        n_servers=n_servers, cores_per_server=cores_per_server,
        chassis_of_server=chassis_of,
        n_chassis=int(chassis_of.max()) + 1), dtype, device)


def score_chassis_batch(state: DeviceClusterState) -> torch.Tensor:
    """Twin of `ClusterState.score_chassis` — (C,)."""
    return 1.0 - state.rho_peak / torch.clamp(state.rho_max, min=1e-9)


def score_server_batch(state: DeviceClusterState, vm_is_uf,
                       cores_per_server: int) -> torch.Tensor:
    """Twin of `ClusterState.score_server`. `vm_is_uf` may be a bool, a
    0-dim tensor, or a (B,) tensor (then the result is (B, S))."""
    uf = torch.as_tensor(vm_is_uf, dtype=torch.bool,
                         device=state.gamma_uf.device)
    if uf.ndim:
        uf = uf[..., None]
    diff = torch.where(uf, state.gamma_nuf - state.gamma_uf,
                       state.gamma_uf - state.gamma_nuf)
    cps = diff.new_full((), float(cores_per_server))
    return 0.5 * (1.0 + diff / cps)


def _rank_weights(scores: torch.Tensor, feasible: torch.Tensor,
                  n_feas: torch.Tensor) -> torch.Tensor:
    """(R, S) rank weights of `core.placement._rank_weight` over the
    feasible subset, per rule row: the stable descending rank r among
    feasible servers (ties to the smaller server index) weighs
    `1 - r/(n-1)`, and a lone feasible server weighs 1. Infeasible
    servers sort last and get weights the caller masks out."""
    key = torch.where(feasible, -scores, torch.inf)
    perm = torch.sort(key, dim=-1, stable=True).indices
    pos = torch.arange(scores.shape[-1], device=scores.device)
    rank = torch.empty_like(perm).scatter_(
        -1, perm, pos.expand_as(perm).contiguous())
    denom = torch.clamp(n_feas - 1, min=1).to(scores.dtype)
    return torch.where(n_feas == 1, 1.0, 1.0 - rank.to(scores.dtype) / denom)


def _as(x, dtype, device):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=dtype, device=device)


def place_batch(state: DeviceClusterState, cores, is_uf, p95_eff, valid,
                rho_cap, policy: SchedulerPolicy, cores_per_server: int,
                mem_gb=None):
    """Place one arrival micro-batch. cores/is_uf/p95_eff/valid: (B,)
    (`valid=False` rows are padding and never touch state); `rho_cap`:
    per-chassis admission ceiling, (C,) on chassis sum(p95*cores) or
    (C, R) over the (watts, cores, GB) ledger (+inf disables an axis);
    `mem_gb`: optional (B,) GB demand (None places zero GB). Returns
    (new_state, servers (B,) int64) with FAIL_* codes for rejects. The
    input state is left as it was."""
    dtype, dev = state.free_cores.dtype, state.free_cores.device
    cores = _as(cores, dtype, dev)
    is_uf = _as(is_uf, torch.bool, dev)
    p95 = _as(p95_eff, dtype, dev)
    valid = _as(valid, torch.bool, dev)
    mem = torch.zeros_like(cores) if mem_gb is None \
        else _as(mem_gb, dtype, dev)
    cap = _as(rho_cap, dtype, dev)
    if cap.ndim == 1:                       # watt-axis ceiling only
        cap = torch.cat([cap[:, None], torch.full(
            (cap.shape[0], N_RESOURCES - 1), torch.inf, dtype=dtype,
            device=dev)], -1)
    # the walk updates private copies in place
    free, g_uf, g_nuf, res = (a.clone() for a in (
        state.free_cores, state.gamma_uf, state.gamma_nuf, state.res_peak))
    chassis_of = state.chassis_of
    cps = free.new_full((), float(cores_per_server))
    rho_max = torch.clamp(state.rho_max, min=1e-9)
    a = policy.alpha
    weights = [policy.packing_weight] \
        + ([policy.power_weight] if policy.use_power_rule else [])
    neg_inf = free.new_full((), -torch.inf)
    out = []
    for i in range(cores.shape[0]):
        feasible = (free >= cores[i]) & valid[i]
        n_feas = feasible.sum()
        rules = [1.0 - free / cps]                          # packing
        if policy.use_power_rule:
            kappa = (1.0 - res[:, 0] / rho_max)[chassis_of]
            diff = torch.where(is_uf[i], g_nuf - g_uf, g_uf - g_nuf)
            eta = 0.5 * (1.0 + diff / cps)
            rules.append(a * kappa + (1.0 - a) * eta)
        rw = _rank_weights(torch.stack(rules), feasible, n_feas)
        obj = weights[0] * rw[0]
        for r in range(1, len(weights)):
            obj = obj + weights[r] * rw[r]
        srv = torch.argmax(torch.where(feasible, obj, neg_inf))
        # admission check + masked state update: capacity fails first,
        # then any axis of the chassis ceiling
        # (indices stay 1-element tensors: indexing by a 0-dim tensor
        # would read it back to the host and stall the walk)
        found = n_feas > 0
        srv = torch.where(found, srv, 0)
        s1 = srv.view(1)
        ch = chassis_of.index_select(0, s1)
        w = p95[i] * cores[i]
        d = torch.stack([w, cores[i], mem[i]])
        admit = torch.all(res.index_select(0, ch) + d
                          <= cap.index_select(0, ch))
        scale = (found & admit & valid[i]).to(dtype)
        uf_f = is_uf[i].to(dtype)
        free.index_add_(0, s1, (-cores[i] * scale).view(1))
        g_uf.index_add_(0, s1, (w * scale * uf_f).view(1))
        g_nuf.index_add_(0, s1, (w * scale * (1.0 - uf_f)).view(1))
        res.index_add_(0, ch, (d * scale)[None])
        out.append(torch.where(~found, FAIL_CAPACITY,
                               torch.where(~admit, FAIL_POWER, srv)))
    servers = torch.stack(out) if out else \
        torch.empty(0, dtype=torch.int64, device=dev)
    return state._replace(free_cores=free, gamma_uf=g_uf, gamma_nuf=g_nuf,
                          res_peak=res), servers


def remove_batch(state: DeviceClusterState, servers, cores, p95_eff, is_uf,
                 mem_gb=None) -> DeviceClusterState:
    """Batch departure (twin of `ClusterState.remove`), crediting the (R,)
    demand back to the ledger. `servers < 0` rows are ignored. Follows
    the state dtype like `place_batch`, so a float64 place/remove
    roundtrip is exact."""
    dtype, dev = state.free_cores.dtype, state.free_cores.device
    servers = _as(servers, torch.int64, dev)
    live = servers >= 0
    srv = torch.where(live, servers, 0)
    scale = live.to(dtype)
    cores = _as(cores, dtype, dev) * scale
    mem = torch.zeros_like(cores) if mem_gb is None \
        else _as(mem_gb, dtype, dev) * scale
    w = _as(p95_eff, dtype, dev) * cores
    uf_f = _as(is_uf, torch.bool, dev).to(dtype)
    d = torch.stack([w, cores, mem], -1)                    # (B, R)
    return state._replace(
        free_cores=state.free_cores.index_add(0, srv, cores),
        gamma_uf=state.gamma_uf.index_add(0, srv, -w * uf_f),
        gamma_nuf=state.gamma_nuf.index_add(0, srv, -w * (1.0 - uf_f)),
        res_peak=state.res_peak.index_add(0, state.chassis_of[srv], -d))


def outcome_counters(servers, valid, cores, p95_eff, mem_gb=None) -> dict:
    """Per-batch decision counts from a placement's outputs (host numpy).
    Padding rows (``valid=False``) are masked out; admits + fail_capacity
    + fail_power + fail_tokens == ``valid.sum()``."""
    servers = np.asarray(servers)
    valid = np.asarray(valid, bool)
    admitted = (servers >= 0) & valid
    cores = np.asarray(cores, np.float64)
    w = np.asarray(p95_eff, np.float64) * cores
    mem = np.zeros_like(cores) if mem_gb is None \
        else np.asarray(mem_gb, np.float64)
    return {
        "admits": int(admitted.sum()),
        "fail_capacity": int(((servers == FAIL_CAPACITY) & valid).sum()),
        "fail_power": int(((servers == FAIL_POWER) & valid).sum()),
        "fail_tokens": int(((servers == FAIL_TOKENS) & valid).sum()),
        "rho_admitted": float(w[admitted].sum()),
        "cores_admitted": float(cores[admitted].sum()),
        "gb_admitted": float(mem[admitted].sum()),
    }
