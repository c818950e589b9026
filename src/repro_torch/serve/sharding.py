"""Sharded serve placement, the torch counterpart of
`repro.serve.sharding`: the cluster state partitioned into N disjoint
shards that place an arrival micro-batch together under a reserve/commit
protocol with power-headroom tokens.

Layout
    Chassis go to shards in contiguous equal blocks (`chassis_to_shard`)
    and servers follow their chassis. Each shard owns a disjoint slice of
    the `DeviceClusterState` over local server and chassis ids, stacked
    along a leading shard axis (`ShardedState`), so only the owner of a
    chassis ever changes it.

Routing
    Arrival i's home shard is ``i % n_shards`` (`route_shard`), so the
    per-shard batches are equal and the protocol is a function of the
    batch alone. With one shard the routing is the identity and the
    protocol is `place_batch`, decision for decision.

Reserve/commit
    A cluster budget converts to an (R,) pool of tokens
    (`resource_pool_from_budget`), split equally over the shards. In the
    home round every shard places its slice against its own state and
    draws its own pool (`placement._walk`, the pooled form of
    `place_batch`); ownership is exclusive and pools disjoint, so the
    budget holds whatever the shards do. Arrivals the home shard rejected
    are offered to the other shards in up to N-1 spillover rounds (round
    r sends arrival i to shard ``(i + r) % n_shards``), with the pools
    rebalanced equally between rounds. Departures credit their own
    shard's pool, so ``sum(committed) <= pool_total`` holds for the life
    of the cluster.

Execution
    On one card the shards run as a leading batch axis, as the
    reference's single-device vmap leg does: a micro-batch walks B/N
    arrival slots, each stepping all N shards at once. The reference's
    mesh leg (`shard_map`, `shard_mesh`, `device_put_sharded_state`) has
    no counterpart on one card.

Every division on a decision path divides by a device tensor: the card
divides by a Python scalar as a multiply by its rounded reciprocal. The
rebalance adds the N pool rows in one fixed order, so it repeats on the
card what it computes on the CPU, bit for bit; like the reference's
compiled mean, it then multiplies by 1/N, while the initial split of the
pool divides, as the reference's does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.placement import SchedulerPolicy
from repro_torch.core.power_model import F_MAX, ServerPowerModel, idle_power
from repro_torch.core.resources import N_RESOURCES, ResourceVector, lift_pool
from repro_torch.device import resolve_device
from repro_torch.serve import adaptive, ballooning, emergency
from repro_torch.serve.placement import (
    FAIL_CAPACITY, DeviceClusterState, SweepCounters, _apply_cap_windows, _as,
    _walk, remove_batch)


class ShardedState(NamedTuple):
    """Cluster state partitioned into N disjoint shard slices. Every
    `shards` leaf carries a leading (N,) axis over local server and
    chassis ids; `global_*` map local winners back to cluster ids and
    `shard_of_server`/`local_of_server` invert them for departures.
    `res_cap` and `pool` run over the (watts, cores, GB) axes; `pool` is
    each shard's remaining balance (+inf on unbudgeted axes; axis 0 is
    in rho units)."""
    shards: DeviceClusterState      # leaves (N, S/N) / (N, C/N) / ...
    global_server: torch.Tensor     # (N, S/N) int64, local -> global id
    global_chassis: torch.Tensor    # (N, C/N) int64
    shard_of_server: torch.Tensor   # (S,) int64, global server -> shard
    local_of_server: torch.Tensor   # (S,) int64, global server -> local id
    res_cap: torch.Tensor           # (N, C/N, R) chassis admission caps
    pool: torch.Tensor              # (N, R) tokens left per resource

    @property
    def n_shards(self) -> int:
        return self.global_server.shape[0]


def chassis_to_shard(n_chassis: int, n_shards: int) -> np.ndarray:
    """(C,) shard owner of each chassis: contiguous equal blocks. The
    shard count must divide the chassis count."""
    if n_chassis % n_shards:
        raise ValueError(
            f"n_shards={n_shards} must divide n_chassis={n_chassis}")
    return np.repeat(np.arange(n_shards, dtype=np.int32),
                     n_chassis // n_shards)


def rho_pool_from_budget(cluster_budget_w, n_servers: int,
                         model: ServerPowerModel | None = None) -> float:
    """Cluster watt budget -> global token pool in rho units: the dynamic
    allowance ``(budget - S * P_idle(f_max)) / p_dyn_per_core``, the
    ceiling on fleet-wide ``sum(p95 * cores)``. None or inf: +inf."""
    if cluster_budget_w is None or np.isinf(cluster_budget_w):
        return float("inf")
    model = model or ServerPowerModel()
    static = n_servers * float(idle_power(F_MAX))
    return max((float(cluster_budget_w) - static) / model.p_dyn_per_core,
               0.0)


def resource_pool_from_budget(budget: ResourceVector, n_servers: int,
                              model: ServerPowerModel | None = None
                              ) -> np.ndarray:
    """Cluster `ResourceVector` budget -> (R,) global token pool (host
    numpy): the watts axis converts as `rho_pool_from_budget`, the
    cores/GB axes are already pool currency; None axes are +inf."""
    vec = budget.as_array()
    vec[0] = rho_pool_from_budget(budget.watts, n_servers, model)
    return vec


def shard_state(state: DeviceClusterState, n_shards: int, rho_cap=None,
                pool_total=None) -> ShardedState:
    """Partition a `DeviceClusterState` into N shard slices, on its
    device. Servers regroup chassis-major (the order of
    `chassis_servers`, which under ``chassis = server // blades`` is the
    server order, so one shard breaks ties as the unsharded walk does).
    `rho_cap`: the global per-chassis ceiling, (C,) on the watt axis or
    (C, R) (None: all +inf); `pool_total`: the global pool, a scalar in
    rho units or (R,) (None: +inf), each axis split equally, divided by
    the shard count as a device tensor."""
    dtype, dev = state.free_cores.dtype, state.free_cores.device
    n_chassis, k = state.chassis_servers.shape
    chassis_to_shard(n_chassis, n_shards)       # validates divisibility
    c_loc = n_chassis // n_shards
    s_loc = c_loc * k
    global_chassis = torch.arange(n_chassis, device=dev).view(n_shards,
                                                              c_loc)
    global_server = state.chassis_servers.reshape(n_shards, s_loc)
    local = torch.arange(s_loc, device=dev)
    shards = DeviceClusterState(
        free_cores=state.free_cores[global_server],
        gamma_uf=state.gamma_uf[global_server],
        gamma_nuf=state.gamma_nuf[global_server],
        res_peak=state.res_peak[global_chassis],
        rho_max=state.rho_max[global_chassis],
        chassis_of=(local // k).repeat(n_shards, 1),
        chassis_servers=local.view(c_loc, k).repeat(n_shards, 1, 1),
        mem_nuf=state.mem_nuf[global_chassis])
    flat = global_server.reshape(-1)
    shard_of = torch.empty_like(flat).index_copy_(
        0, flat, torch.arange(n_shards, device=dev).repeat_interleave(s_loc))
    local_of = torch.empty_like(flat).index_copy_(
        0, flat, local.repeat(n_shards))
    if rho_cap is None:
        cap = torch.full((n_shards, c_loc, N_RESOURCES), torch.inf,
                         dtype=dtype, device=dev)
    else:
        cap = _as(rho_cap, dtype, dev)
        if cap.ndim == 1:
            cap = torch.cat([cap[:, None], torch.full(
                (n_chassis, N_RESOURCES - 1), torch.inf, dtype=dtype,
                device=dev)], -1)
        cap = cap[global_chassis]
    if pool_total is None:
        pool = torch.full((n_shards, N_RESOURCES), torch.inf, dtype=dtype,
                          device=dev)
    else:
        total = _as(lift_pool(np.asarray(pool_total, np.float64)), dtype,
                    dev)
        pool = (total / total.new_full((), n_shards)).expand(
            n_shards, N_RESOURCES).contiguous()
    return ShardedState(shards, global_server, global_chassis, shard_of,
                        local_of, cap, pool)


def unshard_state(sharded: ShardedState) -> DeviceClusterState:
    """The global `DeviceClusterState` view of a sharded state (for
    diagnostics and headroom reports; serving never needs it)."""
    sh = sharded.shards
    n, s_loc = sharded.global_server.shape
    c_loc, k = sh.chassis_servers.shape[1:]
    srv = sharded.global_server.reshape(-1)
    cha = sharded.global_chassis.reshape(-1)

    def by_server(a):
        return torch.empty_like(a.reshape(-1)).index_copy_(0, srv,
                                                           a.reshape(-1))

    def by_chassis(a):
        flat = a.reshape(n * c_loc, *a.shape[2:])
        return torch.empty_like(flat).index_copy_(0, cha, flat)
    chassis_of = torch.gather(sharded.global_chassis, 1, sh.chassis_of)
    return DeviceClusterState(
        free_cores=by_server(sh.free_cores),
        gamma_uf=by_server(sh.gamma_uf),
        gamma_nuf=by_server(sh.gamma_nuf),
        res_peak=by_chassis(sh.res_peak), rho_max=by_chassis(sh.rho_max),
        chassis_of=by_server(chassis_of),
        chassis_servers=by_chassis(sharded.global_server.view(n, c_loc, k)),
        mem_nuf=by_chassis(sh.mem_nuf))


def route_shard(n_arrivals: int, n_shards: int, rnd: int = 0) -> np.ndarray:
    """(B,) target shard of each arrival in spillover round `rnd`: round 0
    is the home shard ``i % n_shards``, later rounds rotate by `rnd` (a
    bijection on shards, so no round sends a shard more than B/N
    arrivals)."""
    return ((np.arange(n_arrivals) + rnd) % n_shards).astype(np.int32)


def _pack_round(pending: np.ndarray, targets: np.ndarray, n_shards: int,
                b_loc: int):
    """Per-shard slots of one round: (N, B/N) arrival indices and attempt
    mask, arrival order kept within each shard."""
    idx = np.zeros((n_shards, b_loc), np.int32)
    attempt = np.zeros((n_shards, b_loc), bool)
    for s in range(n_shards):
        mine = pending[targets[pending] == s]
        idx[s, :len(mine)] = mine
        attempt[s, :len(mine)] = True
    return idx, attempt


def _rebalance(pool: torch.Tensor) -> torch.Tensor:
    """Every shard's row set to the mean of the N rows, as the reference's
    compiled mean takes it: the rows added in index order, times 1/N
    rounded in the pool's dtype (its reciprocal a device-tensor division).
    Each axis total is conserved up to that rounding (+inf axes stay
    +inf)."""
    acc = pool[0]
    for row in pool[1:]:
        acc = acc + row
    one = acc.new_ones(())
    mean = acc * (one / acc.new_full((), pool.shape[0]))
    return mean.expand_as(pool).contiguous()


def place_group_sharded(sharded: ShardedState, cores, is_uf, p95_eff, valid,
                        policy: SchedulerPolicy, cores_per_server: int, *,
                        mem_gb=None, emer=None, caps=None, ecfg=None,
                        registry=None):
    """Place one arrival batch through the whole sharded protocol.

    cores/is_uf/p95_eff/mem_gb: (B,) host arrays or tensors, with B
    divisible by the shard count; `valid` (B,) on the host (False rows
    are padding). Runs the home round and up to N-1 spillover rounds, so
    an arrival fails only if every shard rejected it, with the pools
    equalized before each spillover round.

    `emer`/`caps`/`ecfg` fuse the power-emergency sweep into the home
    round: `caps` is ``(pw, mask, ts)`` stacked (N, W, C/N) (the
    `split_caps` layout, one row per queued unique-chassis window in
    merged order) and `emer` the per-shard `EmergencyState`. The windows
    step before the placement, which is the same as W standalone
    `apply_caps_sharded` calls: a cap touches only the emergency state,
    and reads the pre-batch aggregates either way. Spillover rounds never
    apply them.

    The home round walks all B/N slots of every shard, padding included,
    as the reference does; a spillover round walks only as many slots as
    its fullest shard has pending arrivals (the empty slots after them
    are no-ops), so on the card it costs launches in proportion to what
    spilled.

    Returns ``(sharded_state, servers, info)``: servers (B,) global ids
    with FAIL_* codes (an arrival that failed everywhere reports the most
    severe code it saw), info ``{"rounds", "spilled", "spill_admitted",
    "tokens_drawn", "tokens_drawn_vec"}`` (the draw per axis over every
    round, 0 on +inf axes; `tokens_drawn` is its watts axis). With `emer`
    it returns ``(sharded_state, servers, info, emergency_state,
    sweep)``, the `SweepCounters` summed over shards on the host.

    `registry`, a `repro_torch.obs.MetricsRegistry`, counts each round
    into ``serve_dispatch_total{kind=sharded_round|sharded_round_caps}``,
    the reference's kinds: one count for every round this function runs
    (a home round, and each spillover round it walks over the pending
    slots only), so a round counts as one dispatch though on the card it
    is many launches."""
    n = sharded.n_shards
    valid = np.asarray(valid, bool)
    b = len(valid)
    if b % n:
        raise ValueError(f"batch size {b} not divisible by {n} shards")
    b_loc = b // n
    dtype = sharded.shards.free_cores.dtype
    dev = sharded.shards.free_cores.device
    cores_d = _as(cores, dtype, dev)
    mem_d = torch.zeros_like(cores_d) if mem_gb is None \
        else _as(mem_gb, dtype, dev)
    # the float operands, gathered per round as one (3, N, B/N) block
    ops = torch.stack([cores_d, _as(p95_eff, dtype, dev), mem_d])
    uf_d = _as(is_uf, torch.bool, dev)
    fused = emer is not None
    if fused:
        pw, mask, ts = (_as(a, dt, dev).transpose(0, 1)
                        for a, dt in zip(caps, (dtype, torch.bool, dtype)))

    result = np.full(b, FAIL_CAPACITY, np.int64)
    pending = np.arange(b)[valid]
    shards, pool = sharded.shards, sharded.pool
    pool_start = pool.cpu().numpy()
    has_pool = bool(np.isfinite(pool_start).any())
    info = {"rounds": 0, "spilled": 0, "spill_admitted": 0,
            "tokens_drawn": 0.0,
            "tokens_drawn_vec": np.zeros(pool_start.shape[-1])}
    for rnd in range(n):
        if not len(pending) and not (rnd == 0 and fused):
            break
        if rnd > 0:
            info["spilled"] += len(pending)
            pool = _rebalance(pool)
        idx, attempt = _pack_round(pending, route_shard(b, n, rnd), n,
                                   b_loc)
        if rnd > 0:
            # a spillover round walks only the slots that hold an arrival:
            # the empty ones after them change no state and draw no token
            width = int(attempt.sum(1).max())
            idx, attempt = idx[:, :width], attempt[:, :width]
        idx_d = torch.as_tensor(idx.astype(np.int64)).to(dev)
        att_d = torch.as_tensor(attempt).to(dev)
        c, p, m = ops[:, idx_d]
        if rnd == 0 and fused:
            emer, sw = _apply_cap_windows(ecfg, shards, emer, pw, mask, ts)
            sweep = SweepCounters(*(x.cpu().numpy().sum(axis=0)
                                    for x in sw))
        if registry is not None:
            registry.counter("serve_dispatch_total",
                             kind="sharded_round_caps" if rnd == 0 and fused
                             else "sharded_round").inc()
        # an infinite pool draws nothing: the walk skips the compares
        shards, srv, left = _walk(shards, c, uf_d[idx_d], p, att_d, m,
                                  sharded.res_cap,
                                  pool if has_pool else None, policy,
                                  cores_per_server)
        if has_pool:
            pool = left
        glob = torch.gather(sharded.global_server, 1,
                            torch.clamp(srv, min=0))
        out = torch.where(srv >= 0, glob, srv).cpu().numpy()[attempt]
        arrivals = idx[attempt]
        admitted = out >= 0
        result[arrivals[admitted]] = out[admitted]
        if rnd > 0:
            info["spill_admitted"] += int(admitted.sum())
        failed = arrivals[~admitted]
        # keep the most severe failure reason seen across rounds
        result[failed] = np.minimum(result[failed], out[~admitted])
        pending = np.sort(failed)
        info["rounds"] = rnd + 1
    pool_end = pool.cpu().numpy()
    # the rebalance conserves each axis total, so the per-axis change is
    # what every round admitted; +inf (unbudgeted) axes report 0
    finite = np.isfinite(pool_start).all(axis=0)
    drawn = np.where(finite, pool_start.sum(axis=0)
                     - np.where(finite, pool_end, 0.0).sum(axis=0), 0.0)
    info["tokens_drawn_vec"] = drawn
    info["tokens_drawn"] = float(drawn[0])
    new = sharded._replace(shards=shards, pool=pool)
    if fused:
        # the home round always runs when fused: it must apply the queued
        # windows even with no arrival pending
        return new, result, info, emer, sweep
    return new, result, info


def split_departures(sharded: ShardedState, servers, cores, p95_eff, is_uf,
                     mem_gb=None):
    """Route a global departure batch to per-shard local batches (host
    numpy): ``(local_srv, cores, p95_eff, is_uf, mem_gb)`` stacked (N, B),
    padded with ``local_srv = -1``, each shard's rows in input order.
    Negative server codes are dropped."""
    servers = np.asarray(servers)
    b = len(servers)
    n = sharded.n_shards
    live = servers >= 0
    safe = np.where(live, servers, 0).astype(np.int64)
    owner = np.where(live, sharded.shard_of_server.cpu().numpy()[safe], -1)
    local = sharded.local_of_server.cpu().numpy()[safe]
    srv_out = np.full((n, b), -1, np.int32)
    cores_out = np.zeros((n, b), np.float64)
    p95_out = np.zeros((n, b), np.float64)
    uf_out = np.zeros((n, b), bool)
    mem_out = np.zeros((n, b), np.float64)
    cores = np.asarray(cores, np.float64)
    p95_eff = np.asarray(p95_eff, np.float64)
    is_uf = np.asarray(is_uf, bool)
    mem = np.zeros(b) if mem_gb is None else np.asarray(mem_gb, np.float64)
    for s in range(n):
        mine = owner == s
        k = int(mine.sum())
        srv_out[s, :k] = local[mine]
        cores_out[s, :k] = cores[mine]
        p95_out[s, :k] = p95_eff[mine]
        uf_out[s, :k] = is_uf[mine]
        mem_out[s, :k] = mem[mine]
    return srv_out, cores_out, p95_out, uf_out, mem_out


def _flat(sh: DeviceClusterState) -> DeviceClusterState:
    """The shards as one state over flat ids ``shard * S/N + local``
    (chassis alike): each flat server and chassis belongs to one shard."""
    n, s_loc = sh.free_cores.shape
    c_loc = sh.rho_max.shape[1]
    offs = torch.arange(n, device=sh.chassis_of.device)[:, None] * c_loc
    return DeviceClusterState(
        sh.free_cores.reshape(-1), sh.gamma_uf.reshape(-1),
        sh.gamma_nuf.reshape(-1), sh.res_peak.reshape(n * c_loc, -1),
        sh.rho_max.reshape(-1), (sh.chassis_of + offs).reshape(-1),
        sh.chassis_servers, sh.mem_nuf.reshape(-1))


def consume_departures(sharded: ShardedState, local_srv, cores, p95_eff,
                       is_uf, mem_gb=None) -> ShardedState:
    """Consume per-shard departure batches (the `split_departures`
    layout): each shard's rows leave its own slice, through
    `placement.remove_batch`'s order-fixed sums over flat ids (every
    server and chassis sums only its own shard's rows, in input order),
    and credit the freed ``(p95*cores, cores, GB)`` back to its own pool,
    one axis at a time. The credits are summed on the host in the state's
    dtype, in one fixed order, so the pools repeat bit for bit on the card
    and the CPU."""
    sh = sharded.shards
    n, s_loc = sh.free_cores.shape
    dtype = sh.free_cores.dtype
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    local_srv = np.asarray(local_srv)
    live = local_srv >= 0
    flat = (local_srv + np.arange(n)[:, None] * s_loc)[live]
    cores = np.asarray(cores, np.float64)
    p95_eff = np.asarray(p95_eff, np.float64)
    mem = np.zeros_like(cores) if mem_gb is None \
        else np.asarray(mem_gb, np.float64)
    st = remove_batch(_flat(sh), flat, cores[live], p95_eff[live],
                      np.asarray(is_uf, bool)[live], mem_gb=mem[live])
    c_live = cores.astype(np_dtype) * live.astype(np_dtype)
    w = p95_eff.astype(np_dtype) * c_live
    credit = np.stack([w.sum(-1), c_live.sum(-1),
                       (mem.astype(np_dtype) * live).sum(-1)], -1)
    c_loc = sh.rho_max.shape[1]
    shards = sh._replace(
        free_cores=st.free_cores.view(n, s_loc),
        gamma_uf=st.gamma_uf.view(n, s_loc),
        gamma_nuf=st.gamma_nuf.view(n, s_loc),
        res_peak=st.res_peak.view(n, c_loc, -1),
        mem_nuf=st.mem_nuf.view(n, c_loc))
    pool = sharded.pool + torch.as_tensor(credit).to(sharded.pool.device)
    return sharded._replace(shards=shards, pool=pool)


def remove_sharded(sharded: ShardedState, servers, cores, p95_eff, is_uf,
                   mem_gb=None) -> ShardedState:
    """Sharded twin of `placement.remove_batch`: each departure leaves its
    owner shard (negative server codes are ignored) and credits its (R,)
    demand back to that shard's pool. `split_departures` then
    `consume_departures`."""
    return consume_departures(
        sharded, *split_departures(sharded, servers, cores, p95_eff, is_uf,
                                   mem_gb))


# --- the sharded planes ---------------------------------------------------

def init_emergency_sharded(n_chassis: int, n_shards: int,
                           dtype=torch.float32, device=None):
    """`EmergencyState` partitioned like the cluster: a leading (N,) axis
    over the contiguous chassis blocks of `shard_state`."""
    chassis_to_shard(n_chassis, n_shards)
    return emergency.init_emergency(
        n_chassis // n_shards, batch_shape=(n_shards,), dtype=dtype,
        device=resolve_device(device))


def init_ballooning_sharded(n_chassis: int, n_shards: int,
                            dtype=torch.float32, device=None):
    """`BalloonState` partitioned like the cluster."""
    chassis_to_shard(n_chassis, n_shards)
    return ballooning.init_ballooning(
        n_chassis // n_shards, batch_shape=(n_shards,), dtype=dtype,
        device=resolve_device(device))


def init_adaptive_sharded(cfg, n_chassis: int, n_shards: int,
                          dtype=torch.float32, device=None):
    """`AdaptiveState` partitioned like the cluster: each shard carries
    its own ratio over the budget slice it owns."""
    chassis_to_shard(n_chassis, n_shards)
    return adaptive.init_adaptive(
        cfg, n_chassis // n_shards, batch_shape=(n_shards,), dtype=dtype,
        device=resolve_device(device))


def split_caps(sharded: ShardedState, chassis, power_w, t):
    """Route a global power-sample batch to the dense per-shard
    `masked_step` operands ``(power (N, C/N), mask (N, C/N), t (N,
    C/N))``, host numpy. Chassis within the batch must be unique."""
    n = sharded.n_shards
    c_loc = sharded.global_chassis.shape[1]
    chassis = np.asarray(chassis, np.int64)
    pw = np.zeros((n, c_loc), np.float64)
    mask = np.zeros((n, c_loc), bool)
    ts = np.zeros((n, c_loc), np.float64)
    owner, local = chassis // c_loc, chassis % c_loc
    pw[owner, local] = np.asarray(power_w, np.float64)
    mask[owner, local] = True
    ts[owner, local] = np.asarray(t, np.float64)
    return pw, mask, ts


def _window(sharded: ShardedState, chassis, power_w, t):
    """A window's operands on the state's device, with each shard's
    per-chassis, per-level commitments."""
    sh = sharded.shards
    dtype, dev = sh.free_cores.dtype, sh.free_cores.device
    pw, mask, ts = split_caps(sharded, chassis, power_w, t)
    rho_lv = emergency.chassis_rho_levels(sh.gamma_nuf, sh.gamma_uf,
                                          sh.chassis_servers)
    return (rho_lv, _as(pw, dtype, dev), torch.as_tensor(mask).to(dev),
            _as(ts, dtype, dev))


def apply_caps_sharded(cfg: emergency.EmergencyConfig, sharded: ShardedState,
                       emer, chassis, power_w, t):
    """Apply one unique-chassis power-sample window to the sharded
    emergency state: samples go to their owner shards and every shard
    steps at once against its own aggregates (no cross-shard traffic).
    Returns ``(emergency_state, EmergencyOutputs)`` with the shard axis."""
    rho_lv, pw, mask, ts = _window(sharded, chassis, power_w, t)
    return emergency.masked_step(cfg, emer, rho_lv, pw, mask, ts)


def apply_caps_ballooned_sharded(ecfg: emergency.EmergencyConfig,
                                 bcfg: ballooning.BallooningConfig,
                                 sharded: ShardedState, emer, bst, chassis,
                                 power_w, t):
    """`apply_caps_sharded` with the ballooning rung in front: each shard
    balloons its alarmed chassis against its own NUF memory ledger, then
    steps the emergency state on the adjusted draws. Returns
    ``(emergency_state, balloon_state, EmergencyOutputs,
    BalloonOutputs)``, all with the shard axis."""
    rho_lv, pw, mask, ts = _window(sharded, chassis, power_w, t)
    bst, bout = ballooning.balloon_step(bcfg, ecfg, bst, rho_lv, pw,
                                        sharded.shards.mem_nuf, mask)
    emer, out = emergency.masked_step(ecfg, emer, rho_lv, bout.power_adj_w,
                                      mask, ts)
    return emer, bst, out, bout


def apply_adaptive_sharded(cfg, sharded: ShardedState, ast, chassis,
                           power_w):
    """Step every shard's adaptive controller on one unique-chassis sample
    window: each shard scores its own chassis and steps its own ratio.
    Returns ``(adaptive_state, AdaptiveOutputs)`` with the shard axis."""
    rho_lv, pw, mask, _ = _window(sharded, chassis, power_w,
                                  np.zeros(len(np.asarray(chassis))))
    return adaptive.adaptive_step(cfg, ast, rho_lv, pw, mask)
