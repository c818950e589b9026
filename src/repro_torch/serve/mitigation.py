"""Mitigation planning: migrate persistently capped critical VMs, the
counterpart of `repro.serve.mitigation` (host numpy, carried over so the
same inputs give the same plan).

Criticality-aware capping (`serve.emergency`) protects critical VMs from
*transient* emergencies; a chassis that stays capped past the dwell
threshold with its critical level throttled needs its load *moved*, not
shaved (the paper's mitigation: persistently capped critical VMs are
migrated to chassis with headroom). This module plans those moves
deterministically and expresses them in the ingest stream's own
vocabulary:

  * **Plan** — `plan_migrations` walks the dwell-flagged chassis in id
    order and greedily moves their *cheapest* critical VMs (smallest
    committed ``p95*cores``, ties to registry order) to the chassis with
    the most power headroom that can hold them, until the source's
    offered draw fits back under the capping target. Working copies of
    the aggregates see every earlier move, so the plan is a pure
    function of its inputs.
  * **Paired depart/arrive events** — `MigrationPlan.as_events` turns
    each move into a departure row on the source server plus a *pinned*
    arrival on the destination, encoded as a negated-cores
    `DepartureBatch` row: `serve.placement.remove_batch` with
    ``cores < 0`` is exactly a placement. `paired_stamps` gives each pair
    adjacent unique timestamps, so the merged stream orders depart before
    arrive and the plan is invariant to how its rows are dealt across
    ingest hosts.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.serve.emergency import (CRIT_UF, EmergencyConfig,
                                         sampled_power_np)
from repro_torch.serve.ingest import DepartureBatch


@dataclass
class LiveVMs:
    """Struct-of-arrays registry of the VMs currently placed — the
    per-VM view the aggregate-only serve state cannot reconstruct, so
    the component that owns placements (the scheduler simulation, or a
    production inventory service) supplies it. `token` is the caller's
    stable VM identity (defaults to the row index)."""
    server: np.ndarray              # (V,) int32 — current server
    cores: np.ndarray               # (V,) float
    p95_eff: np.ndarray             # (V,) float — p95 at placement
    is_uf: np.ndarray               # (V,) bool
    token: np.ndarray = None        # (V,) int64 — caller's VM id
    mem_gb: np.ndarray = None       # (V,) float — GB at placement

    def __post_init__(self):
        if self.token is None:
            self.token = np.arange(len(self.server), dtype=np.int64)
        if self.mem_gb is None:
            self.mem_gb = np.zeros(len(self.server), np.float64)

    def __len__(self) -> int:
        return len(self.server)


@dataclass
class MigrationPlan:
    """One deterministic batch of planned moves, in plan order."""
    vm: np.ndarray                  # (M,) int64 — row into the registry
    token: np.ndarray               # (M,) int64 — caller's VM id
    src_server: np.ndarray          # (M,) int32
    dst_server: np.ndarray          # (M,) int32
    cores: np.ndarray               # (M,) float
    p95_eff: np.ndarray             # (M,) float
    is_uf: np.ndarray               # (M,) bool
    mem_gb: np.ndarray = None       # (M,) float — GB moving with the VM

    def __post_init__(self):
        if self.mem_gb is None:
            self.mem_gb = np.zeros(len(self.vm), np.float64)

    def __len__(self) -> int:
        return len(self.vm)

    def as_events(self) -> tuple:
        """The plan as paired stream events: ``(departs, arrives)``
        `DepartureBatch` pairs, row i of each being move i. The arrive
        leg is the *pinned placement* encoding — the same server-keyed
        wire format with negated cores, which `remove_batch` turns into
        an exact placement. Push row i of `departs` strictly before row i of
        `arrives` (see `paired_stamps`)."""
        dep = DepartureBatch(self.src_server.astype(np.int32),
                             self.cores.astype(np.float32),
                             self.p95_eff.astype(np.float32),
                             self.is_uf.astype(bool),
                             self.mem_gb.astype(np.float32))
        arr = DepartureBatch(self.dst_server.astype(np.int32),
                             (-self.cores).astype(np.float32),
                             self.p95_eff.astype(np.float32),
                             self.is_uf.astype(bool),
                             (-self.mem_gb).astype(np.float32))
        return dep, arr

    def paired_stamps(self, t0: float, eps: float = 1e-7) -> tuple:
        """``(depart_t, arrive_t)`` stamps strictly after `t0`: move
        i departs at ``t0 + (2i+1)*eps`` and arrives at
        ``t0 + (2i+2)*eps`` — globally unique, depart-before-arrive
        per pair, plan-ordered across pairs. Unique stamps are what
        make the merged event order (and therefore every downstream
        decision) invariant to which ingest host each row lands on."""
        i = np.arange(len(self.vm), dtype=np.float64)
        return t0 + (2 * i + 1) * eps, t0 + (2 * i + 2) * eps


def _empty_plan() -> MigrationPlan:
    return MigrationPlan(np.empty(0, np.int64), np.empty(0, np.int64),
                         np.empty(0, np.int32), np.empty(0, np.int32),
                         np.empty(0, np.float64), np.empty(0, np.float64),
                         np.empty(0, bool), np.empty(0, np.float64))


def plan_migrations(cfg: EmergencyConfig, live: LiveVMs,
                    chassis_of: np.ndarray, free_cores: np.ndarray,
                    rho_lv: np.ndarray, util: float, due: np.ndarray,
                    max_moves_per_chassis: int = 2,
                    max_moves: int = 32, *,
                    mem_chassis: np.ndarray = None,
                    gb_cap: np.ndarray = None) -> MigrationPlan:
    """Plan migrations for every dwell-flagged chassis.

    chassis_of: (S,) server->chassis; free_cores: (S,) current free
    cores; rho_lv: (C, L) committed p95*cores per criticality level
    (`serve.emergency.chassis_rho_levels_np`); util: the current
    utilization sample (the emergency plane's view of how hot the
    commitment is running); due: (C,) bool from
    `serve.emergency.mitigation_due_np`.

    Per due chassis (ascending id): move its cheapest critical VMs —
    smallest ``p95*cores``, ties toward the earlier registry row —
    to the eligible chassis with the most post-move power headroom
    (ties toward the smaller chassis id; destination server is the
    emptiest feasible blade, ties toward the smaller id), until the
    source's offered draw fits under ``cfg.target_w`` or the move caps
    run out. A destination is eligible while it is not itself due and
    its post-move draw stays under the alarm threshold — mitigation
    must never *create* an emergency. All greedy state lives in
    working copies, so the returned plan is a pure function of the
    inputs (asserted under event permutation in tests).

    mem_chassis/gb_cap: (C,) committed GB and GB capacity per chassis
    (`DeviceClusterState.res_peak[:, R_GB]` and the admission
    ceiling's GB column). When given, a destination must also hold
    the VM's memory, so a move never lands on a chassis with cores but
    no GB. ``None`` (either) disables the check."""
    due = np.asarray(due, bool)
    if not due.any() or not len(live):
        return _empty_plan()
    chassis_of = np.asarray(chassis_of)
    n_chassis = rho_lv.shape[0]
    free = np.asarray(free_cores, np.float64).copy()
    rho = np.asarray(rho_lv, np.float64).copy()
    util = float(util)
    check_mem = mem_chassis is not None and gb_cap is not None
    if check_mem:
        mem_c = np.asarray(mem_chassis, np.float64).copy()
        cap_gb = np.broadcast_to(
            np.asarray(gb_cap, np.float64), (n_chassis,))
    # per-chassis server lists, id-ordered (deterministic dst pick)
    servers_of = [np.flatnonzero(chassis_of == c)
                  for c in range(n_chassis)]
    vm_chassis = chassis_of[live.server]
    w_vm = np.asarray(live.p95_eff, np.float64) \
        * np.asarray(live.cores, np.float64)
    moved = np.zeros(len(live), bool)

    def offered(c: int) -> float:
        return float(sampled_power_np(
            cfg, rho[c], util, np.zeros(rho.shape[-1], np.int32), False))

    rows = {"vm": [], "token": [], "src": [], "dst": [], "cores": [],
            "p95": [], "uf": [], "mem": []}
    for c in np.flatnonzero(due):
        # cheapest critical VMs on this chassis, registry order on ties
        cand = np.flatnonzero((vm_chassis == c) & np.asarray(live.is_uf)
                              & ~moved)
        cand = cand[np.argsort(w_vm[cand], kind="stable")]
        moves_left = max_moves_per_chassis
        for v in cand:
            if moves_left == 0 or len(rows["vm"]) >= max_moves:
                break
            if offered(c) <= cfg.target_w:
                break
            cores_v = float(live.cores[v])
            mem_v = float(live.mem_gb[v])
            # eligible destinations: not due, can hold the VM (cores
            # on a blade AND GB on the chassis), and stay under the
            # alarm threshold after taking it
            dst_c, dst_s, best_head = -1, -1, -np.inf
            for c2 in range(n_chassis):
                if c2 == c or due[c2]:
                    continue
                if check_mem and mem_c[c2] + mem_v > cap_gb[c2]:
                    continue
                srv = servers_of[c2]
                fit = srv[free[srv] >= cores_v]
                if not len(fit):
                    continue
                after = rho[c2].copy()
                after[CRIT_UF] += w_vm[v]
                p_after = float(sampled_power_np(
                    cfg, after, util, np.zeros(rho.shape[-1], np.int32),
                    False))
                head = cfg.alert_w - p_after
                if head <= 0 or head <= best_head:
                    continue
                dst_c, best_head = c2, head
                dst_s = int(fit[np.argmax(free[fit])])
            if dst_c < 0:
                continue
            src_s = int(live.server[v])
            free[src_s] += cores_v
            free[dst_s] -= cores_v
            rho[c, CRIT_UF] -= w_vm[v]
            rho[dst_c, CRIT_UF] += w_vm[v]
            if check_mem:
                mem_c[c] -= mem_v
                mem_c[dst_c] += mem_v
            moved[v] = True
            moves_left -= 1
            rows["vm"].append(int(v))
            rows["token"].append(int(live.token[v]))
            rows["src"].append(src_s)
            rows["dst"].append(dst_s)
            rows["cores"].append(cores_v)
            rows["p95"].append(float(live.p95_eff[v]))
            rows["uf"].append(bool(live.is_uf[v]))
            rows["mem"].append(mem_v)
    return MigrationPlan(
        np.asarray(rows["vm"], np.int64),
        np.asarray(rows["token"], np.int64),
        np.asarray(rows["src"], np.int32),
        np.asarray(rows["dst"], np.int32),
        np.asarray(rows["cores"], np.float64),
        np.asarray(rows["p95"], np.float64),
        np.asarray(rows["uf"], bool),
        np.asarray(rows["mem"], np.float64))
