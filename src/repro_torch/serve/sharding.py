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
    are offered to the other shards in spillover rounds (round r sends
    arrival i to shard ``(i + r) % n_shards``; `spill_rounds` of them,
    N-1 by default), with the pools rebalanced equally before each
    (unless `rebalance=False`). Departures credit their own
    shard's pool, so ``sum(committed) <= pool_total`` holds for the life
    of the cluster.

Execution
    Two legs run the same per-shard arithmetic and decide alike. The
    batch-axis leg runs the shards as a leading batch axis on one device,
    as the reference's single-device vmap leg does: a micro-batch walks
    B/N arrival slots, each stepping all N shards at once. The mesh leg,
    the counterpart of the reference's `shard_map` over a ``("shard",)``
    mesh, puts each shard on its own device: `shard_mesh` names N
    devices, one shard a position, and `device_put_sharded_state` splits
    the stacked state into N one-shard groups (`OnMesh`), each holding
    its own state, pool and plane states there. A round launches every
    position's walk before it reads any result back, so distinct cards
    walk at once; routing, round packing and the global ids stay on the
    host, and the rebalance gathers the N pool rows in shard order,
    adds them as the batch-axis leg does, and hands each position its
    row. A device may repeat in a mesh (``("cuda:0",) * 4``): the leg
    then runs one position after another on it, with the same
    arithmetic. The controller is one process, as the reference's
    pipeline is; `torch.distributed` plays no part.

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


#: `ShardedState` fields over all servers (no shard axis): every group of
#: a mesh holds them whole, as the reference replicates them.
_REPLICATED = ("shard_of_server", "local_of_server")


class OnMesh(NamedTuple):
    """A value with a leading shard axis placed on a mesh
    (`device_put_sharded_state`):
    `groups[i]` is its slice for mesh position i, that axis cut to 1, on
    position i's device and in its own memory. A `ShardedState` on a mesh
    is N one-shard `ShardedState`s."""
    groups: tuple

    @property
    def n_shards(self) -> int:
        return len(self.groups)

    @property
    def devices(self) -> tuple:
        return tuple(_first_tensor(g).device for g in self.groups)


def _first_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else _first_tensor(x[0])


def _mesh_device(d) -> torch.device:
    """A mesh position's device, its CUDA index made explicit; a card the
    machine does not have raises."""
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d}: no CUDA device available")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d.index >= torch.cuda.device_count():
            raise RuntimeError(f"mesh device {d}: the machine has "
                               f"{torch.cuda.device_count()} cards")
    return d


def shard_mesh(n_shards: int, devices=None):
    """The mesh of N shards, a tuple of N `torch.device`s, one shard a
    position: the single-controller counterpart of the reference's 1-D
    ``("shard",)`` mesh. Without `devices`, the first N cards, or None
    when the machine has fewer (the batch-axis leg then runs every shard
    on one device, deciding alike). With `devices`, those N devices; one
    may repeat (``("cpu",) * 4``, ``("cuda:0",) * 4``), which runs the
    mesh leg's per-position arithmetic on one device."""
    if devices is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < n_shards:
            return None
        return tuple(torch.device("cuda", i) for i in range(n_shards))
    mesh = tuple(_mesh_device(d) for d in devices)
    if len(mesh) != n_shards:
        raise ValueError(f"a mesh of {n_shards} shards takes {n_shards} "
                         f"devices, got {len(mesh)}")
    return mesh


def _slice(x, i: int, dev):
    if torch.is_tensor(x):
        return x[i:i + 1].to(dev, copy=True)
    rep = _REPLICATED if isinstance(x, ShardedState) else ()
    return type(x)(*(v.to(dev, copy=True) if f in rep else _slice(v, i, dev)
                     for f, v in zip(x._fields, x)))


def _join(groups: list, dev):
    first = groups[0]
    if torch.is_tensor(first):
        return torch.cat([g.to(dev) for g in groups])
    rep = _REPLICATED if isinstance(first, ShardedState) else ()
    return type(first)(*(
        v.to(dev) if f in rep else _join([g[k] for g in groups], dev)
        for k, (f, v) in enumerate(zip(first._fields, first))))


def device_put_sharded_state(x, mesh):
    """Put each shard's slice of a value with a leading (N,) shard axis (a
    stacked `ShardedState`, or a plane's state) on its mesh device: an
    `OnMesh` of N one-shard groups, each copied to its position's device
    (a `ShardedState`'s groups each hold the whole inverse tables). A
    value already on `mesh` is returned as it is, one on another mesh
    raises; None stays None."""
    if x is None:
        return None
    mesh = tuple(_mesh_device(d) for d in mesh)
    if isinstance(x, OnMesh):
        if x.devices != mesh:
            raise ValueError(f"the value lies on the mesh {x.devices}, "
                             f"not on {mesh}")
        return x
    n = x.n_shards if isinstance(x, ShardedState) \
        else _first_tensor(x).shape[0]
    if n != len(mesh):
        raise ValueError(f"{n} shards do not map onto a mesh of "
                         f"{len(mesh)} devices")
    return OnMesh(tuple(_slice(x, i, d) for i, d in enumerate(mesh)))


def from_mesh(x, device=None):
    """The stacked value of an `OnMesh`, its groups joined along the shard
    axis in mesh order on `device` (None: the first position's); any
    other value as it is."""
    if not isinstance(x, OnMesh):
        return x
    return _join(list(x.groups),
                 x.devices[0] if device is None else torch.device(device))


def groups_of(x) -> list:
    """The groups a leg steps: a mesh's one-shard groups, or a stacked
    value as its one group of N shards."""
    return list(x.groups) if isinstance(x, OnMesh) else [x]


def regroup(like, groups: list):
    """`groups` in the form of `like`: an `OnMesh` for a mesh value, else
    the one stacked group."""
    return OnMesh(tuple(groups)) if isinstance(like, OnMesh) else groups[0]


def shard_blocks(sharded) -> list:
    """The slices of the shard axis each group of `groups_of` holds, in
    its order."""
    n = sharded.n_shards
    return [slice(i, i + 1) for i in range(n)] \
        if isinstance(sharded, OnMesh) else [slice(0, n)]


def _placed(mesh, sharded, *states):
    """The state put on `mesh` (when given), and the plane states on the
    state's mesh when it has one."""
    if mesh is not None:
        sharded = device_put_sharded_state(sharded, mesh)
    if isinstance(sharded, OnMesh):
        states = tuple(device_put_sharded_state(s, sharded.devices)
                       for s in states)
    elif any(isinstance(s, OnMesh) for s in states):
        raise ValueError("a plane state lies on a mesh and the cluster "
                         "state does not: pass mesh=")
    return (sharded, *states)


def pool_left(sharded) -> np.ndarray:
    """(N, R) tokens left per shard and axis, on the host, of a stacked
    or a mesh state."""
    return np.concatenate([g.pool.cpu().numpy() for g in groups_of(sharded)])


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


def unshard_state(sharded, device=None) -> DeviceClusterState:
    """The global `DeviceClusterState` view of a sharded state, stacked or
    on a mesh (gathered to `device`, None: its first position's), for
    diagnostics and headroom reports; serving never needs it."""
    sharded = from_mesh(sharded, device)
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


def _rebalance(pools: list, blocks: list) -> list:
    """Every shard's row set to the mean of the N rows, as the reference's
    compiled mean takes it: the rows added in index order, times 1/N
    rounded in the pool's dtype (its reciprocal a device-tensor division).
    On a mesh the rows are gathered to the first group's device in shard
    order and each group is handed its rows back. Each axis total is
    conserved up to that rounding (+inf axes stay +inf)."""
    rows = pools[0] if len(pools) == 1 \
        else torch.cat([p.to(pools[0].device) for p in pools])
    acc = rows[0]
    for row in rows[1:]:
        acc = acc + row
    one = acc.new_ones(())
    mean = (acc * (one / acc.new_full((), rows.shape[0]))).expand_as(rows)
    if len(pools) == 1:
        return [mean.contiguous()]
    return [mean[blk].to(p.device, copy=True) for p, blk in zip(pools,
                                                                 blocks)]


def place_group_sharded(sharded, cores, is_uf, p95_eff, valid,
                        policy: SchedulerPolicy, cores_per_server: int, *,
                        mem_gb=None, mesh=None,
                        spill_rounds: int | None = None,
                        rebalance: bool = True, emer=None, caps=None,
                        ecfg=None, registry=None):
    """Place one arrival batch through the whole sharded protocol.

    cores/is_uf/p95_eff/mem_gb: (B,) host arrays or tensors, with B
    divisible by the shard count; `valid` (B,) on the host (False rows
    are padding). Runs the home round and up to `spill_rounds` spillover
    rounds (None: N-1, so an arrival fails only if every shard rejected
    it), with the pools equalized before each spillover round unless
    `rebalance` is False.

    `sharded` is a stacked `ShardedState` (the batch-axis leg) or one on a
    mesh (`device_put_sharded_state`, the mesh leg); `mesh`, a
    `shard_mesh`, puts a stacked state on it first. On a mesh every
    position walks its own shard on its own device, all launched before a
    result is read back, and the state and emergency state come back on
    the mesh.

    `emer`/`caps`/`ecfg` fuse the power-emergency sweep into the home
    round: `caps` is ``(pw, mask, ts)`` stacked (N, W, C/N) (the
    `split_caps` layout, one row per queued unique-chassis window in
    merged order) and `emer` the per-shard `EmergencyState`. The windows
    step before the placement, which is the same as W standalone
    `apply_caps_sharded` calls: a cap touches only the emergency state,
    and reads the pre-batch aggregates either way. Spillover rounds never
    apply them.

    The home round walks all B/N slots of every shard, padding included,
    as the reference does; a spillover round walks, in each group, only
    as many slots as its fullest shard has pending arrivals (the empty
    slots after them are no-ops), so on the card it costs launches in
    proportion to what spilled.

    Returns ``(sharded_state, servers, info)``: servers (B,) global ids
    with FAIL_* codes (an arrival that failed everywhere reports the most
    severe code it saw), info ``{"rounds", "spilled", "spill_admitted",
    "tokens_drawn", "tokens_drawn_vec"}`` (the draw per axis over every
    round, 0 on +inf axes; `tokens_drawn` is its watts axis). With `emer`
    it returns ``(sharded_state, servers, info, emergency_state,
    sweep)``, the `SweepCounters` summed over shards on the host.

    `registry`, a `repro_torch.obs.MetricsRegistry`, counts each round
    into ``serve_dispatch_total{kind=sharded_round|sharded_round_caps}``,
    the reference's kinds: one count for every round this function runs,
    whatever its launches and devices."""
    sharded, emer = _placed(mesh, sharded, emer)
    n = sharded.n_shards
    valid = np.asarray(valid, bool)
    b = len(valid)
    if b % n:
        raise ValueError(f"batch size {b} not divisible by {n} shards")
    b_loc = b // n
    if spill_rounds is None:
        spill_rounds = n - 1
    groups, blocks = groups_of(sharded), shard_blocks(sharded)
    devs = [g.pool.device for g in groups]
    dtype = groups[0].shards.free_cores.dtype
    cores_d = _as(cores, dtype, devs[0])
    mem_d = torch.zeros_like(cores_d) if mem_gb is None \
        else _as(mem_gb, dtype, devs[0])
    # the float operands, gathered per round as one (3, k, slots) block,
    # and the UF flags, each on every group's device
    ops0 = torch.stack([cores_d, _as(p95_eff, dtype, devs[0]), mem_d])
    uf0 = _as(is_uf, torch.bool, devs[0])
    ops = [ops0.to(d) for d in devs]
    ufs = [uf0.to(d) for d in devs]
    fused = emer is not None
    if fused:
        emers = groups_of(emer)
        windows = [[_as(a[blk], dt, d).transpose(0, 1) for a, dt in zip(
            caps, (dtype, torch.bool, dtype))] for blk, d in zip(blocks,
                                                                  devs)]

    result = np.full(b, FAIL_CAPACITY, np.int64)
    pending = np.arange(b)[valid]
    shards = [g.shards for g in groups]
    pools = [g.pool for g in groups]
    pool_start = pool_left(sharded)
    has_pool = bool(np.isfinite(pool_start).any())
    info = {"rounds": 0, "spilled": 0, "spill_admitted": 0,
            "tokens_drawn": 0.0,
            "tokens_drawn_vec": np.zeros(pool_start.shape[-1])}
    for rnd in range(spill_rounds + 1):
        if not len(pending) and not (rnd == 0 and fused):
            break
        if rnd > 0:
            info["spilled"] += len(pending)
            if rebalance:
                pools = _rebalance(pools, blocks)
        idx, attempt = _pack_round(pending, route_shard(b, n, rnd), n,
                                   b_loc)
        if registry is not None:
            registry.counter("serve_dispatch_total",
                             kind="sharded_round_caps" if rnd == 0 and fused
                             else "sharded_round").inc()
        # launch every group's walk, then read the results back
        outs, sweeps = [], []
        for j, (g, blk, dev) in enumerate(zip(groups, blocks, devs)):
            g_idx, g_att = idx[blk], attempt[blk]
            if rnd > 0:
                # a spillover round walks only the slots that hold an
                # arrival: the empty ones after them change no state and
                # draw no token
                width = int(g_att.sum(1).max())
                if not width:
                    continue
                g_idx, g_att = g_idx[:, :width], g_att[:, :width]
            idx_d = torch.as_tensor(g_idx.astype(np.int64)).to(dev)
            att_d = torch.as_tensor(g_att).to(dev)
            c, p, m = ops[j][:, idx_d]
            if rnd == 0 and fused:
                emers[j], sw = _apply_cap_windows(ecfg, shards[j], emers[j],
                                                  *windows[j])
                sweeps.append(sw)
            # an infinite pool draws nothing: the walk skips the compares
            shards[j], srv, left = _walk(
                shards[j], c, ufs[j][idx_d], p, att_d, m, g.res_cap,
                pools[j] if has_pool else None, policy, cores_per_server)
            if has_pool:
                pools[j] = left
            glob = torch.gather(g.global_server, 1, torch.clamp(srv, min=0))
            outs.append((torch.where(srv >= 0, glob, srv), g_idx, g_att))
        if sweeps:
            sweep = SweepCounters(*(np.concatenate(
                [x.cpu().numpy() for x in col]).sum(axis=0)
                for col in zip(*sweeps)))
        out = np.concatenate([o.cpu().numpy()[a] for o, _, a in outs])
        arrivals = np.concatenate([i[a] for _, i, a in outs])
        admitted = out >= 0
        result[arrivals[admitted]] = out[admitted]
        if rnd > 0:
            info["spill_admitted"] += int(admitted.sum())
        failed = arrivals[~admitted]
        # keep the most severe failure reason seen across rounds
        result[failed] = np.minimum(result[failed], out[~admitted])
        pending = np.sort(failed)
        info["rounds"] = rnd + 1
    new = regroup(sharded, [g._replace(shards=s, pool=p)
                            for g, s, p in zip(groups, shards, pools)])
    pool_end = pool_left(new)
    # the rebalance conserves each axis total, so the per-axis change is
    # what every round admitted; +inf (unbudgeted) axes report 0
    finite = np.isfinite(pool_start).all(axis=0)
    drawn = np.where(finite, pool_start.sum(axis=0)
                     - np.where(finite, pool_end, 0.0).sum(axis=0), 0.0)
    info["tokens_drawn_vec"] = drawn
    info["tokens_drawn"] = float(drawn[0])
    if fused:
        # the home round always runs when fused: it must apply the queued
        # windows even with no arrival pending
        return new, result, info, regroup(sharded, emers), sweep
    return new, result, info


def split_departures(sharded, servers, cores, p95_eff, is_uf, mem_gb=None):
    """Route a global departure batch to per-shard local batches (host
    numpy): ``(local_srv, cores, p95_eff, is_uf, mem_gb)`` stacked (N, B),
    padded with ``local_srv = -1``, each shard's rows in input order.
    Negative server codes are dropped. `sharded` is stacked or on a
    mesh."""
    servers = np.asarray(servers)
    b = len(servers)
    n = sharded.n_shards
    tables = groups_of(sharded)[0]       # the inverse tables, whole
    live = servers >= 0
    safe = np.where(live, servers, 0).astype(np.int64)
    owner = np.where(live, tables.shard_of_server.cpu().numpy()[safe], -1)
    local = tables.local_of_server.cpu().numpy()[safe]
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


def consume_departures(sharded, local_srv, cores, p95_eff, is_uf,
                       mem_gb=None):
    """Consume per-shard departure batches (the `split_departures`
    layout) on a stacked or a mesh state: each shard's rows leave its own
    slice, on its own device, through `placement.remove_batch`'s
    order-fixed sums over flat ids (every server and chassis sums only
    its own shard's rows, in input order), and credit the freed
    ``(p95*cores, cores, GB)`` back to its own pool, one axis at a time.
    The credits are summed on the host in the state's dtype, in one fixed
    order, so the pools repeat bit for bit on the card and the CPU."""
    local_srv = np.asarray(local_srv)
    cores = np.asarray(cores, np.float64)
    p95_eff = np.asarray(p95_eff, np.float64)
    is_uf = np.asarray(is_uf, bool)
    mem = np.zeros_like(cores) if mem_gb is None \
        else np.asarray(mem_gb, np.float64)
    return regroup(sharded, [
        _consume(g, local_srv[blk], cores[blk], p95_eff[blk], is_uf[blk],
                 mem[blk])
        for g, blk in zip(groups_of(sharded), shard_blocks(sharded))])


def _consume(sharded: ShardedState, local_srv, cores, p95_eff, is_uf, mem):
    """`consume_departures` on one group of shards."""
    sh = sharded.shards
    n, s_loc = sh.free_cores.shape
    dtype = sh.free_cores.dtype
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    live = local_srv >= 0
    flat = (local_srv + np.arange(n)[:, None] * s_loc)[live]
    st = remove_batch(_flat(sh), flat, cores[live], p95_eff[live],
                      is_uf[live], mem_gb=mem[live])
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


def remove_sharded(sharded, servers, cores, p95_eff, is_uf, mem_gb=None):
    """Sharded twin of `placement.remove_batch`: each departure leaves its
    owner shard (negative server codes are ignored) and credits its (R,)
    demand back to that shard's pool, on a stacked or a mesh state.
    `split_departures` then `consume_departures`."""
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


def split_caps(sharded, chassis, power_w, t):
    """Route a global power-sample batch to the dense per-shard
    `masked_step` operands ``(power (N, C/N), mask (N, C/N), t (N,
    C/N))``, host numpy. Chassis within the batch must be unique."""
    n = sharded.n_shards
    c_loc = groups_of(sharded)[0].global_chassis.shape[1]
    chassis = np.asarray(chassis, np.int64)
    pw = np.zeros((n, c_loc), np.float64)
    mask = np.zeros((n, c_loc), bool)
    ts = np.zeros((n, c_loc), np.float64)
    owner, local = chassis // c_loc, chassis % c_loc
    pw[owner, local] = np.asarray(power_w, np.float64)
    mask[owner, local] = True
    ts[owner, local] = np.asarray(t, np.float64)
    return pw, mask, ts


def _windows(sharded, chassis, power_w, t) -> list:
    """A window's operands for each group, on its device, with each
    shard's per-chassis, per-level commitments: (group, rho_lv, pw, mask,
    ts)."""
    pw, mask, ts = split_caps(sharded, chassis, power_w, t)
    out = []
    for g, blk in zip(groups_of(sharded), shard_blocks(sharded)):
        sh = g.shards
        dtype, dev = sh.free_cores.dtype, sh.free_cores.device
        rho_lv = emergency.chassis_rho_levels(sh.gamma_nuf, sh.gamma_uf,
                                              sh.chassis_servers)
        out.append((g, rho_lv, _as(pw[blk], dtype, dev),
                    torch.as_tensor(mask[blk]).to(dev),
                    _as(ts[blk], dtype, dev)))
    return out


def _outputs(parts: list):
    """Per-group step outputs joined along the shard axis on the first
    group's device (the host reads them)."""
    return parts[0] if len(parts) == 1 \
        else _join(parts, _first_tensor(parts[0]).device)


def apply_caps_sharded(cfg: emergency.EmergencyConfig, sharded, emer,
                       chassis, power_w, t, *, mesh=None):
    """Apply one unique-chassis power-sample window to the sharded
    emergency state: samples go to their owner shards and every shard
    steps at once against its own aggregates (no cross-shard traffic), on
    its own device on a mesh. Returns ``(emergency_state,
    EmergencyOutputs)``: the state in the form of `sharded` (on its mesh
    if it has one, `mesh` putting both there first), the outputs with the
    shard axis."""
    sharded, emer = _placed(mesh, sharded, emer)
    steps = [emergency.masked_step(cfg, e, rho_lv, pw, mask, ts)
             for e, (_, rho_lv, pw, mask, ts) in zip(
                 groups_of(emer), _windows(sharded, chassis, power_w, t))]
    return (regroup(sharded, [s[0] for s in steps]),
            _outputs([s[1] for s in steps]))


def apply_caps_ballooned_sharded(ecfg: emergency.EmergencyConfig,
                                 bcfg: ballooning.BallooningConfig,
                                 sharded, emer, bst, chassis, power_w, t, *,
                                 mesh=None):
    """`apply_caps_sharded` with the ballooning rung in front: each shard
    balloons its alarmed chassis against its own NUF memory ledger, then
    steps the emergency state on the adjusted draws. Returns
    ``(emergency_state, balloon_state, EmergencyOutputs,
    BalloonOutputs)``, the states in the form of `sharded`, the outputs
    with the shard axis."""
    sharded, emer, bst = _placed(mesh, sharded, emer, bst)
    steps = []
    for e, b, (g, rho_lv, pw, mask, ts) in zip(
            groups_of(emer), groups_of(bst),
            _windows(sharded, chassis, power_w, t)):
        b, bout = ballooning.balloon_step(bcfg, ecfg, b, rho_lv, pw,
                                          g.shards.mem_nuf, mask)
        e, out = emergency.masked_step(ecfg, e, rho_lv, bout.power_adj_w,
                                       mask, ts)
        steps.append((e, b, out, bout))
    return (regroup(sharded, [s[0] for s in steps]),
            regroup(sharded, [s[1] for s in steps]),
            _outputs([s[2] for s in steps]), _outputs([s[3] for s in steps]))


def apply_adaptive_sharded(cfg, sharded, ast, chassis, power_w, *,
                           mesh=None):
    """Step every shard's adaptive controller on one unique-chassis sample
    window: each shard scores its own chassis and steps its own ratio.
    Returns ``(adaptive_state, AdaptiveOutputs)``, the state in the form
    of `sharded`, the outputs with the shard axis."""
    sharded, ast = _placed(mesh, sharded, ast)
    steps = [adaptive.adaptive_step(cfg, a, rho_lv, pw, mask)
             for a, (_, rho_lv, pw, mask, _) in zip(
                 groups_of(ast), _windows(sharded, chassis, power_w,
                                          np.zeros(len(np.asarray(
                                              chassis)))))]
    return (regroup(sharded, [s[0] for s in steps]),
            _outputs([s[1] for s in steps]))
