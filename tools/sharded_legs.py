#!/usr/bin/env python3
"""Time the two legs of sharded serving against each other on the cards.

    python tools/sharded_legs.py [--seed N] [--turns K] [--out FILE]

Sets up `chip_smoke.py`'s serving cell (its population, labels, forests
and chassis budget, the main path served once on cuda:0) and serves the
budgeted 4-shard cell (`sharded_serve`'s `shards_4_budget`: 720 servers,
4,096 arrivals in micro-batches of 256, a cluster pool of 80 % of the
rho one shard admits) through `ShardedServePipeline` on each leg, in
turns: the batch axis on cuda:0 (`batch_axis`), the mesh over cuda:0
repeated (`one_card`) and, on a machine with 4 cards, the mesh over
cuda:0..3 (`cards`); K turns, the order reversed every other turn. Every
run's decisions, final state, pools left and spill counters must equal
the first batch-axis run's, bit for bit. Per run: arrivals/s over the
cell and batch p50/p99 (each micro-batch ends in a host fetch from every
card); on a micro-batch after the cell, under torch.profiler, launches
per arrival and each card's busy device ms against the wall. Prints the
cards' names and power limits first (one line each), then one JSON line
per run and a summary line, which `--out` also writes. Needs a card and
the CUDA toolkit; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as C  # noqa: E402

SHARDS = 4


def setup(seed: int, dev):
    """The serving cell's inputs on `dev`: chip_smoke's main path served
    once, its chassis budget, the cluster budget of `shards_4_budget` (one
    shard decides as the main path, so its admitted rho is the main
    path's) and two micro-batches after the cell."""
    from repro_torch.core import features as F
    from repro_torch.core.power_model import F_MAX, ServerPowerModel, \
        idle_power
    from repro_torch.core.predictor import bucket_to_p95
    from repro_torch.sim.telemetry import arrival_batch, generate_population
    pop = generate_population(C.N_VMS, seed=seed)
    hist, rest = F.split_history_arrivals(pop)
    arrivals = type(rest)(vms=rest.vms[:C.N_ARRIVALS])
    true_rho = float(np.dot(
        [v.cores for v in arrivals.vms],
        bucket_to_p95(F.p95_bucket([v.p95_util for v in arrivals.vms]))))
    model = ServerPowerModel()
    budget_w = C.BLADES * model.p_idle \
        + true_rho / (C.N_SERVERS // C.BLADES) * model.p_dyn_per_core
    run = C.main_path(pop, hist, arrivals, budget_w, dev)
    cores = run["batch"].cores.astype(np.float64)
    pool = C.SHARD_POOL_SHARE * C._outcomes(run["parts"],
                                            cores)["rho_admitted"]
    cluster_w = C.N_SERVERS * float(idle_power(F_MAX)) \
        + model.p_dyn_per_core * pool
    nxt = rest.vms[C.N_ARRIVALS:C.N_ARRIVALS + 2 * C.BATCH]
    extra = (arrival_batch(type(rest)(vms=nxt[:C.BATCH])),
             arrival_batch(type(rest)(vms=nxt[C.BATCH:])))
    return run, hist, budget_w, cluster_w, extra


def legs(n_cards: int, dev) -> list:
    """(name, mesh devices or None) of each leg this machine runs."""
    out = [("batch_axis", None), ("one_card", (str(dev),) * SHARDS)]
    if n_cards >= SHARDS:
        out.append(("cards", tuple(f"cuda:{i}" for i in range(SHARDS))))
    return out


def synchronize() -> None:
    import torch
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def profile(pipe, batch_a, batch_b) -> dict:
    """Host wall of serving `batch_a` unprofiled against what the
    profiler traces while `batch_b` is served: busy device ms per card,
    kernel launches, launches per arrival."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace
    synchronize()
    t0 = time.perf_counter()
    pipe.serve(batch_a)
    synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        pipe.serve(batch_b)
        synchronize()
    busy, launches = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = f"cuda:{e.device_index}"
            busy[key] = busy.get(key, 0.0) + e.self_device_time_total / 1e3
        elif e.name == "cudaLaunchKernel":
            launches += 1
    return {"wall_ms": wall_ms, "device_busy_ms": busy or "not measured",
            "device_idle_share": {k: 1.0 - v / wall_ms
                                  for k, v in busy.items()}
            or "not measured",
            "launches": launches,
            "launches_per_arrival": launches / len(batch_b)}


def serve(name, mesh, run, hist, budget_w, cluster_w, extra, dev):
    """One served run of the cell on a leg: its record, and what the
    runs are held equal on."""
    from repro_torch.serve import shard_mesh
    pipe, parts, wall, bm, _, _ = C._sharded_serve_run(
        run, hist, budget_w, SHARDS, dev, cluster_w,
        mesh=None if mesh is None else shard_mesh(SHARDS, devices=mesh))
    synchronize()
    s = sorted(bm)
    cores = run["batch"].cores.astype(np.float64)
    rec = {"leg": name, "mesh": None if mesh is None else list(mesh),
           "arrivals_per_s": C.N_ARRIVALS / wall, "wall_s": wall,
           "batch_p50_ms": float(np.percentile(s, 50)),
           "batch_p99_ms": float(np.percentile(s, 99)),
           **C._outcomes(parts, cores), "spill": dict(pipe.spill_info)}
    held = (np.concatenate([p.server for p in parts]), pipe.global_state(),
            pipe.pool_left_vec(), dict(pipe.spill_info))
    rec["profile"] = {**profile(pipe, *extra),
                      "micro_batch": "after the cell"}
    return rec, held


def same(held, base, what: str) -> None:
    import torch
    srv, state, pools, spill = held
    b_srv, b_state, b_pools, b_spill = base
    C.check(np.array_equal(srv, b_srv), f"{what}: the decisions")
    for f, a, b in zip(state._fields, state, b_state):
        C.check(torch.equal(a, b), f"{what}: final {f} bit-equal")
    C.check(np.array_equal(pools, b_pools), f"{what}: pools left")
    C.check(spill == b_spill, f"{what}: spill counters {spill} {b_spill}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sharded_legs: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    for line in smi:
        print(line, flush=True)
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    build.build()
    cell = setup(args.seed, dev)
    print(json.dumps({"setup_s": time.perf_counter() - t0,
                      "cluster_budget_w": cell[3]}), flush=True)
    order = legs(torch.cuda.device_count(), dev)
    runs, base = [], None
    for turn in range(args.turns):
        for name, mesh in (order if turn % 2 == 0 else order[::-1]):
            rec, held = serve(name, mesh, *cell, dev)
            if base is None:
                base = held
            else:
                same(held, base, f"{name}, turn {turn}")
            rec["turn"] = turn
            runs.append(rec)
            print(json.dumps(rec), flush=True)
    summary = {"cards": smi, "legs": {}}
    for name, _ in order:
        mine = [r for r in runs if r["leg"] == name]
        summary["legs"][name] = {
            "arrivals_per_s": [r["arrivals_per_s"] for r in mine],
            "batch_p50_ms": [r["batch_p50_ms"] for r in mine],
            "batch_p99_ms": [r["batch_p99_ms"] for r in mine],
            "launches_per_arrival": [r["profile"]["launches_per_arrival"]
                                     for r in mine],
            "device_busy_ms": [r["profile"]["device_busy_ms"] for r in mine],
            "profile_wall_ms": [r["profile"]["wall_ms"] for r in mine]}
    if len(order) < 3:
        summary["legs"]["cards"] = {
            "run": False, "why": f"the machine has "
            f"{torch.cuda.device_count()} card(s); the mesh over distinct "
            f"cards takes {SHARDS}"}
    summary["equal"] = True
    line = json.dumps(summary)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
