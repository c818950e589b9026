#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

It builds the port's four CUDA kernels from `src/repro_torch/csrc`
(printing ptxas's registers and spills, and the tensor-core and TMA
instructions in each kernel's SASS: every bf16 flash and SSD
instantiation must have HGMMA and UTMALDG), holds
each kernel against its plain torch version on the card, at the paths'
shapes and at each kernel's edge shapes (forest:
one row, ragged batches, stacks over 48 KB of tables, depths 1, 8 and
12, K 1, 4 and 10; template: T 48 to 1,056 and 6,192 (the medians'
digit select), constant, zero and tied rows, and its block path timed at 8,000 x 1,440 and 8,000 x 4,320, its
static shared memory within what `MAX_T_BLOCK` leaves it;
flash and SSD in bf16, flash also causal at Lk < Lq, whose first
Lq - Lk rows see no key, and at head dims 20 and 100, timed at Zamba2's
heads; SSD also on the model's strided views of one conv buffer, which
must give the contiguous call's output bit for bit, as must a repeated
call), and drives the port's two paths:

- the placement path at the full width of one real cluster: label an
  8,000-VM history with the template kernel, train the four forests on
  the host, and serve 4,096 arrivals in micro-batches of 256 on 720
  servers (60 chassis x 12 blades x 40 cores) under a chassis watt
  budget, with the forest kernel on every micro-batch. It checks the
  decisions (outcome counts, capacity and power ceilings, launch counts,
  and identical servers from the same serve through the port on the CPU);
- LM serving of Zamba2-2.7B at full width (54 Mamba2 layers, d 2,560, a
  shared attention block after every 6, seeded random bf16 weights):
  the batch prefill of 8 prompts of 512 tokens through the flash-attention
  and SSD kernels, then `serve_batch` on their first 128 tokens with 32
  generated tokens through the cache path. It checks the launch counts
  (9 flash, 54 SSD per prefill), finite logits, a prefill of the 128
  tokens against the cache path, and the kernel forward against the
  plain forward;
- LM serving of the moe, audio and vlm families (`lm_families`), one
  model at a time at full width with seeded bf16 weights: mixtral-8x22b
  cut to 8 layers (prefill 8 x 512, under its expert capacity),
  whisper-tiny whole (8 x 64 decoder tokens over 1,500 frames),
  qwen2-vl-72b cut to 4 layers (8 x 512 with 256 patch embeddings) and
  arctic-480b cut to 1 layer (128 experts, 4 x 64). Each prefill runs
  through the flash kernel (a launch a self-attention layer, and a
  cross-attention layer for whisper, whose encoder runs 'chunked' as the
  reference's), is timed beside the plain prefill and held against the
  plain forward; `serve_batch`'s prompt logits are held against a prefill
  of the same prompts (mixtral's at 4 x 512, dropless). For MoE both
  comparisons go layer by layer on shared inputs, expert choices first:
  a token whose choice flips must be a near tie, and is exempt at that
  layer (over a whole forward a flip's new state reaches later tokens
  through attention). It prints the dropped share, decode tokens/s and a
  decode step's profile, and times the flash kernel at mixtral's head
  shape beside SDPA;
- the evaluation path, which runs no hand-written kernel: the fleet
  engine on the Fig 4-5 server and the Fig 6 chassis against its numpy
  oracle at the reference's bars (`fleet_parity`), at 1, 64 and 1,024
  chassis with launches per step and the device's idle share
  (`fleet_scale`), a Table IV sweep and its frontier (`table4_sweep`),
  and the Fig 7 scheduler simulation over SIM_DAYS days with its event
  backend on the host and its serve backend on the card, which must
  place alike, an admission-budget run and a power evaluation
  (`scheduler_sim`);
- the streamed serving loop with the power-emergency plane
  (`streamed_serve`): the history labeled again on the card, then the
  serving cell's 4,096 arrivals pushed through `submit_to` over a warm
  cluster at the paper's 2x chassis budget (1,860 W), with a departure
  stream through `depart_to`, a cap sweep of all 60 chassis through
  `cap_to` every 4 micro-batches (`sampled_power` at util 0.85 on the
  live aggregates) and one migration cycle (due chassis ->
  `plan_migrations` -> paired events -> `depart_to` -> `reset_dwell`).
  It checks alarms, a forest launch per micro-batch, equal decisions,
  alarms, throttled-seconds and final state at 1 and 4 ingest hosts,
  the card's decisions against the same stream on the CPU, and a
  repeated card run bit-equal to the first; it prints arrivals/s with
  the plane off and on, launches per micro-batch and per cap window, and
  the device idle share;
- the emergency plane in the scheduler simulation (`sim_emergency`) at
  the reference benchmark's 2x settings, aware and blind, on the event
  backend on the host and (aware) on the serve backend on the card,
  whose torch twin is held bit-equal to the numpy oracle on every scan:
  equal traces and `SimMetrics`, aware critical throttled-seconds below
  blind, beside the reference's record in BENCH_serve_emergency.json;
- the example twins on the card (`examples`): the quickstart through
  the template and forest kernels, the datacenter scenario through the
  template kernel and the torch fleet engine, their numbers printed; the
  training twins `train_lm` (its loss must fall) and `serve_capped` (the
  serving job at full frequency, the training job throttled), which
  launch no hand-written kernel;
- the streamed cell with the ballooning rung and the adaptive controller
  (`streamed_planes`): the rung alone at the streamed cell's own sweeps
  beside that cell, then both planes with a sweep after every micro-batch at a
  utilization that rises, runs hot and calms, at 1 and 4 hosts, on the
  CPU with the card's sweep powers and once more on the card; decisions,
  alarms, throttled-seconds and the planes' states must agree, the rung
  must fire and the controller ratchet and back off; launches per cap
  window with each rung;
- the mitigation ladder and the adaptive arm of the reference benchmarks
  in the scheduler simulation on the serve backend (`sim_ladder`,
  `sim_adaptive`), the ballooning and adaptive twins stepped and checked
  on the card at every scan, every field against its target (the
  recorded BENCH_serve_resources.json arm; the reference's own output
  for the adaptive arm cut to SIM_ADAPTIVE's 0.5 days);
- sharded serving (`sharded_serve`, `sharded_planes`, `sim_sharded`): the
  serving cell through `ShardedServePipeline` at 1, 2 and 4 shards (1
  shard gives the main path's decisions and final state bit for bit; 2
  and 4 shards the CPU's decisions and a repeated card run's bits) and at
  4 shards under a cluster budget of 80 % of the rho 1 shard admitted
  (the pools hold the budget, run out, spill and account for every
  admission); the streamed cell with both planes at 4 shards over 1,024
  arrivals, at 1 and 4 hosts and on the CPU, and at 1 shard against the
  unsharded pipeline; the Fig 7 simulation on the serve-sharded backend
  (1 shard gives the event trace; 4 shards on the CPU the card's trace;
  the reference test's cluster budget rejects with every group's token
  conservation check holding), with arrivals/s, launches per arrival
  (the sharded serving runs profiled whole, spills included) and the
  device idle share;
- the mesh leg of sharded serving (`sharded_mesh`): the budgeted 4-shard
  cell with one shard a position of a mesh over the card repeated
  (`shard_mesh(4, devices=("cuda:0",) * 4)`, the table row-partitioned
  over it), held bit for bit to a batch-axis card run (decisions, final
  state, pools, spill counters; a forest launch per micro-batch), its
  arrivals/s, batch p50/p99 and, on a micro-batch after the cell,
  launches per arrival and idle share beside the batch axis's; the
  both-planes streamed arm on the mesh against the batch axis (decisions,
  alarms, ratios, every plane state); over cuda:0..3 too where the
  machine has 4 cards, else why not;
- the observability plane (`obs_serve`, `obs_streamed`, `obs_sharded`,
  `monitor`): the serving cell with `Observability.full()` (the main
  path's decisions and state bit for bit, its counters those decisions,
  every arrival scored and the scorecard reconciled with
  `core.forest.evaluate`; arrivals/s and launches per micro-batch with
  obs off and on); the streamed cell with both planes and obs at 1 and 4
  hosts (the obs-off run's decisions, alarms and throttled-seconds, sweep
  counters that are the plane's, and the flight recorder replayed on a
  fresh card pipeline); the 4-shard cell under the pool (obs on decides
  as off, tokens drawn minus credited is the pools' change, the spill
  counters the pipeline's); and `repro_torch.launch.monitor --sim` at 4
  shards on the card (its snapshot, Prometheus text and alerts written
  under build/obs_monitor/ and read back);
- LM training (`lm_train`): reduced phi4-mini in float32 on the card
  against the CPU (loss, grad norm, every gradient leaf, TF32 off); two
  train steps from one state bit for bit (reduced phi4-mini, mixtral and
  zamba2 at 8 x 512 tokens); phi4-mini-3.8b at full width and depth
  through `launch.train` (AdamW, 8 x 512 tokens, TRAIN_STEPS steps: ms a
  step, tokens/s, model TFLOP/s, peak memory, the host snapshot's
  seconds, one profiled step; the four kernels launch 0 times, as the
  reference trains outside its kernels); 8 of its layers with remat on
  and off and with 2 micro-batches; qwen2-vl-72b cut to 2 layers with its
  Adafactor and 256 patch embeddings; and the train_lm twin's demo-20m
  with injected failures, which must end in the failure-free run's state,
  its checkpoint from the card restored on the CPU.

It also builds the serving cell's history table twice and serves the
arrivals twice, and checks the tables bit-equal and the decisions equal
(`featurizer_determinism`).

Each phase prints one JSON line, with the seconds since the script
started (`t_s`). Then come the card's name and power
limit as `nvidia-smi` prints them, a `{"kernels": [...]}` line with each
kernel's launches on the main path, error against its plain version,
times and bound (one-call `ms`; `device_ms` from back-to-back calls; for
forest and template also the profiler's `kernel_device_ms` and the
wrapper's `host_us` per call; for flash and SSD achieved TFLOP/s; the
bound shares), and last `{"ok": true, "device": {...}}`. It exits
non-zero, with no result, when no CUDA device is present, and on any
failed check. It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: H100 SXM data-sheet peaks: HBM bytes/s, float32 operations/s
#: outside the tensor cores, dense bf16 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
#: The peaks the flash and SSD bounds divide by, printed beside them.
BF16_PEAKS = {"bytes_per_s": HBM_BYTES_PER_S, "bytes": "HBM",
              "ops_per_s": BF16_OPS_PER_S,
              "ops": "dense bf16 tensor cores"}

#: Main-path cluster: the 720-server cluster of BENCH_serve.json.
N_SERVERS, CORES, BLADES = 720, 40, 12
N_VMS, N_ARRIVALS, BATCH = 16000, 4096, 256
FLEET_ROWS = 65536
TEMPLATE_RTOL, TEMPLATE_ATOL = 5e-3, 5e-4
FOREST_ATOL = 1e-5
TIMED_RUNS = 20
#: Fields of a forest or template phase that its `kernels` entry carries.
TIMES = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
         "kernel_device_ms", "host_us", "bound_share", "device_bound_share")

#: LM path: Zamba2-2.7B, a prefill of 8 prompts of 512 tokens; serve_batch
#: on their first LM_SERVE_PROMPT tokens with 32 generated (its cache path
#: feeds the prompt a token a step, ~80 ms a step on the card's host: at
#: 512 tokens it took 40.7 s of the script); the long prompt of the kernel
#: phases.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "zamba2-2.7b", 8, 512, 32
LM_SERVE_PROMPT = 128
LONG_PROMPT = 4096
#: Bars of tests/test_kernels.py: flash in float32 and bf16, SSD in
#: float32. An SSD output in bf16 (|y| reaches ~200 at Zamba2's inputs)
#: can round to the neighbouring bf16 value, so it gets the bf16 bar plus
#: one bf16 ulp (at most 2^-7 relative).
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_ATOL, SSD_BF16_ATOL, SSD_BF16_RTOL = 2e-4, 2e-2, 2.0 ** -7
#: Prefill against the cache path, and the kernel forward against the
#: plain forward, in bf16: the reference's prefill/decode bar
#: (tests/test_models_smoke.py), held here at 54 layers.
LM_ATOL, LM_RTOL = 0.15, 0.1
#: Evaluation path: the fleet engine held to the reference's numpy-vs-jax
#: bars (tests/test_fleet_engine.py) on the Fig 4-5 and Fig 6 setups, the
#: scale runs of BENCH_fleet_engine.json (the balanced chassis, 150
#: steps), a Table IV grid for the Fig 4-5 server, and the scheduler
#: simulation.
FLEET_BARS = {"power_w": 0.5, "min_nuf_freq": 1e-5, "rapl_frac": 0.01,
              "uf_p95_rel": 1e-3, "nuf_slowdown_rel": 1e-3}
FIG45 = [(230.0, "per_vm"), (230.0, "rapl"), (210.0, "per_vm")]
FLEET_DUR_S = 60.0
FLEET_SCALE, FLEET_STEPS = (1, 64, 1024), 150
T4_BUDGETS = (290.0, 280.0, 270.0, 260.0, 250.0, 240.0, 230.0, 220.0, 210.0)
T4_LOADS, T4_FLOORS = (1.0, 0.9, 0.8), (0.5, 0.6, 0.75)
#: The Fig 7 run's length, cut from the reference test's 4 days to keep
#: the whole script's time (1 day until PR 25: its serve run took 18.7 s).
SIM_DAYS = 0.5


def mesh_step(seed: int, dev) -> dict:
    """(a): one fsdp2d train step on a one-rank NCCL DeviceMesh (1, 1)
    against the plain step from the same state, bit for bit where it is
    (else each differing leaf is named and held at the training bars),
    with both steps' ms and the kernel launches (the training path
    launches none). On one rank a shard is the whole tensor, so the
    state is placed with `DTensor.from_local` at the strategy's
    placements, without a copy; the plain step's results wait on the
    host."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import MeshSpec, build_mesh
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import get_optimizer
    from repro_torch.tree import leaves_with_path, tree_map
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_CMP_LAYERS)
    _free()
    params = T.init_params(cfg, seed, device=dev)
    state = get_optimizer(cfg.optimizer).init(params)
    batch = _token_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed, dev)
    step = make_train_step(cfg, impl="naive")
    host = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731

    def timed(fn, runs=3):
        out, ms = None, []
        for _ in range(runs):
            out = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(ms[1:])

    reset_launches()
    (p1, s1, m1), plain_ms = timed(lambda: step(params, state, batch))
    p1, s1, m1 = host(p1), host(s1), host(m1)
    g1 = host(loss_and_grads(cfg, params, batch, "naive")[1])
    _free()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = build_mesh(MeshSpec((1, 1), ("data", "model")), dev)
            strat = shd.make_strategy("fsdp2d", mesh)
            names = ("params", "opt_state", "batch")
            placed = [tree_map(lambda t, s: DTensor.from_local(
                t, mesh, s.placements, run_check=False), a, sh)
                for a, sh in zip((params, state, batch), shd.arg_shardings(
                    strat, mesh, names, (params, state, batch)))]
            with shd.use_strategy(strat, mesh):
                (p2, s2, m2), sharded_ms = timed(lambda: step(*placed))
                p2, s2, m2 = (host(shd.gather(t)) for t in (p2, s2, m2))
                g2 = host(shd.gather(loss_and_grads(
                    cfg, placed[0], placed[2], "naive")[1]))
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    launches = dict(KERNEL_LAUNCHES)
    del placed, params, state
    _free()
    differ = {}
    for tag, a, b in (("param", p1, p2), ("opt_state", s1, s2),
                      ("grad", g1, g2)):
        other = dict(leaves_with_path(b))
        for path, t in leaves_with_path(a):
            if not torch.equal(t, other[path]):
                gap = (t.float() - other[path].float()).abs().max()
                differ[f"{tag}/{'/'.join(map(str, path))}"] = float(
                    gap / t.float().abs().max().clamp(min=1e-30))
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "cut": f"{TRAIN_CMP_LAYERS} of 32 layers: the plain and the "
                  "sharded step's states side by side do not fit at full "
                  "depth",
           "mesh": [1, 1], "backend": "nccl", "strategy": "fsdp2d",
           "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "loss": [float(m1["loss"]), float(m2["loss"])],
           "grad_norm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
           "bit_equal": not differ and torch.equal(m1["loss"], m2["loss"])
           and torch.equal(m1["grad_norm"], m2["grad_norm"]),
           "differing_leaves": differ,
           "plain_ms_per_step": plain_ms, "sharded_ms_per_step": sharded_ms,
           "kernel_launches": launches}
    del p1, s1, p2, s2, g1, g2
    check(sum(launches.values()) == 0,
          f"the train steps launch no hand-written kernel: {launches}")
    if not out["bit_equal"]:
        loss_gap = abs(out["loss"][1] / out["loss"][0] - 1)
        gnorm_gap = abs(out["grad_norm"][1] / out["grad_norm"][0] - 1)
        grad_gap = max([v for k, v in differ.items()
                        if k.startswith("grad/")] or [0.0])
        check(loss_gap <= TRAIN_LOSS_RTOL and gnorm_gap <= TRAIN_GNORM_RTOL
              and grad_gap <= TRAIN_GRAD_REL_ATOL,
              f"the sharded step within the training bars of the plain "
              f"one: {out}")
    return out


def mesh_dryrun(jobs: int | None = None) -> dict:
    """(b): the dry-run of MESH_DRYRUN_CELLS under fsdp2d on both
    production meshes through the CLI (a process a cell for both meshes,
    fake groups, no card), each with its argument GB a device against the card's 80 GB,
    FLOPs and collective bytes a device, the roofline terms at the H100's
    peaks and its seconds."""
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import roofline
    art = Path(__file__).resolve().parent / "build" / "dryrun_torch"
    jobs = jobs or MESH_DRYRUN_JOBS
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(
        Path(__file__).resolve().parent / "src"))
    archs = sorted({a for a, _ in MESH_DRYRUN_CELLS})
    shapes = sorted({s for _, s in MESH_DRYRUN_CELLS})
    procs = []
    # a process a cell, both meshes in it one after the other (the fake
    # group is re-made at the second mesh's size): half the start-ups
    for arch, shape in MESH_DRYRUN_CELLS:
        procs.append(((arch, shape), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", arch, "--shape", shape, "--strategy", "fsdp2d",
             "--force", "--in-process", "--artifact-dir", str(art)],
            env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)))
        while sum(p.poll() is None for _, p in procs) >= jobs:
            time.sleep(0.2)
    for _, p in procs:
        p.wait(timeout=900)
    cells = {}
    hbm_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    for (arch, shape, mp), p in ((cell + (mp,), p) for cell, p in procs
                                 for mp in (False, True)):
        name = f"{arch}__{shape}__pod{2 if mp else 1}__fsdp2d"
        with open(art / f"{name}.json") as f:
            rec = json.load(f)
        row = {"status": rec["status"], "exit": p.returncode,
               "seconds": rec.get("run_s")}
        if rec["status"] == "ok":
            terms = roofline.roofline_row(rec, ARCHS[arch], SHAPES[shape],
                                          chips=512 if mp else 256)
            row.update(
                argument_gb_per_device=rec["memory"]["argument_bytes"] / 1e9,
                card_gb=hbm_gb,
                flops_per_device=rec["cost"]["flops"],
                collective_bytes_per_device=rec["collectives"]["total_bytes"],
                collectives=rec["collectives"],
                **{k: terms[k] for k in ("t_compute_s", "t_memory_s",
                                         "t_collective_s", "dominant",
                                         "roofline_overlapped")})
        else:
            row["error"] = rec.get("error")
        cells[name] = row
    out = {"strategy": "fsdp2d", "meshes": [[16, 16], [2, 16, 16]],
           "archs": archs, "shapes": shapes, "cells": cells,
           "seconds": time.perf_counter() - t0, "jobs": jobs}
    check(all(c["status"] == "ok" and c["exit"] == 0
              for c in cells.values()),
          f"every dry-run cell ok: { {k: c.get('error') or c['status'] for k, c in cells.items() if c['status'] != 'ok'} }")
    return out


def mesh_multi_card() -> dict:
    """(c): with two cards or more, the sharded step on 2 NCCL ranks of a
    (1, 2) mesh against the plain step (reduced llama3-8b, float32, two
    steps) at the training bars."""
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        return {"run": False, "cards": n,
                "why": f"{n} card(s) on this machine: the multi-rank NCCL "
                       "step needs two or more"}
    from repro_torch.tree import leaves_with_path
    out_file = Path(__file__).resolve().parent / "build" / "mesh_2cards.pt"
    env = dict(os.environ, PYTHONPATH=str(
        Path(__file__).resolve().parent / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sharded", "--arch",
         "llama3-8b", "--reduced", "--mesh", "1,2", "--steps", "2",
         "--out", str(out_file)], env=env, capture_output=True, text=True,
        timeout=600)
    check(proc.returncode == 0, f"2-card sharded step: {proc.stderr[-2000:]}")
    rec = torch.load(out_file, weights_only=False)
    plain, sharded = rec["plain"], rec["sharded"]
    grad_gap = 0.0
    for gp, gs in zip(plain["grads"], sharded["grads"]):
        other = dict(leaves_with_path(gs))
        for path, t in leaves_with_path(gp):
            grad_gap = max(grad_gap, float(
                (t - other[path]).abs().max() / t.abs().max().clamp(
                    min=1e-30)))
    out = {"run": True, "cards": n, "mesh": [1, 2], "arch": "llama3-8b "
           "reduced, float32, 2 steps", "loss": [plain["loss"],
                                                 sharded["loss"]],
           "grad_norm": [plain["grad_norm"], sharded["grad_norm"]],
           "max_grad_gap_over_leaf_max": grad_gap,
           "shard_errors": sharded["shard_errors"]}
    check(np.allclose(sharded["loss"], plain["loss"], rtol=TRAIN_LOSS_RTOL,
                      atol=0)
          and np.allclose(sharded["grad_norm"], plain["grad_norm"],
                          rtol=TRAIN_GNORM_RTOL, atol=0)
          and grad_gap <= TRAIN_GRAD_REL_ATOL
          and not any(sharded["shard_errors"]),
          f"the 2-card sharded step within the training bars: {out}")
    return out


def mesh_phase(seed: int, dev) -> dict:
    """The mesh layer on the card: (a) `mesh_step`, (b) `mesh_dryrun`,
    (c) `mesh_multi_card`, each line emitted as it ends. The mesh layer
    adds no kernel and its path launches none."""
    t0 = time.perf_counter()
    out = {}
    for name, fn in (("step", lambda: mesh_step(seed, dev)),
                     ("dryrun", mesh_dryrun),
                     ("multi_card", mesh_multi_card)):
        out[name] = fn()
        emit(f"mesh_{name}", **out[name])
    out["seconds"] = time.perf_counter() - t0
    emit("mesh", seconds=out["seconds"],
         kernels="the mesh layer adds no kernel; its path launches none")
    return out


#: The profiled serve-backend run of the Fig 7 phase. Its launches per
#: arrival move with the run's length (~900 over 0.1 days, ~690 over
#: 0.25). When the trace was read through `key_averages()` the profiler
#: cost ~0.7 ms a launch: 0.25 days took 145 s of the script.
SIM_PROFILE_DAYS = 0.1
TIGHT_BUDGET_W = 12 * 112.0 + 60.0

#: LM training (`lm_train`): phi4-mini-3.8b at full width through
#: `launch.train` (8 x 512 tokens a step, TRAIN_STEPS steps, the median
#: of steps 2 on), 8 of its layers for the remat and micro-batch
#: comparisons, qwen2-vl-72b cut to 2 of 80 layers with its Adafactor and
#: 256 patch embeddings, and the train_lm twin's demo-20m under injected
#: failures. The card against the CPU: reduced phi4-mini in float32 (TF32
#: off), loss rtol 1e-5, grad norm rtol 1e-4, every gradient leaf within
#: 1e-5 of its largest |g|.
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "phi4-mini-3.8b", 8, 512, 6
TRAIN_CMP_LAYERS, VLM_TRAIN_LAYERS = 8, 2
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_GRAD_REL_ATOL = 1e-5, 1e-4, 1e-5
#: Micro-batches 1 against 2 (and remat on against off): grad norm
#: within this relative gap of each other.
TRAIN_MICRO_GNORM_RTOL = 1e-5
FT_STEPS, FT_RATE, FT_EVERY = 40, 0.2, 5

#: The mesh phase (`mesh_phase`). (a) The fsdp2d train step on a one-rank
#: NCCL DeviceMesh (1, 1) against the plain step from the same state:
#: phi4-mini-3.8b at full width cut to TRAIN_CMP_LAYERS layers (both
#: steps' states side by side do not fit at full depth), TRAIN_BATCH x
#: TRAIN_SEQ tokens, impl 'naive' as `launch.train` runs. (b) The dry-run
#: (`launch.dryrun`, fake process groups of 256 and 512 ranks, meta
#: shards) of the cells below under fsdp2d on (16, 16) and (2, 16, 16),
#: a process a cell for both meshes, all at once: every family's decode
#: cell, the prefill of the dense, vlm and audio families and the train
#: cell of the audio one. The SSM and hybrid prefill and train cells (2-6
#: min a cell on the card's host), the moe and vlm train cells (2-4 min),
#: and the dense train and moe prefill cells (~38 s a mesh, the longest
#: of the rest, cut to keep the script's time) are left to the whole
#: grid, which `python -m repro_torch.launch.dryrun --jobs 8` runs in ~9
#: min a strategy. (c) More than one card: the sharded step on 2 NCCL
#: ranks against 1 (`launch.sharded`).
MESH_DRYRUN_CELLS = (
    ("phi4-mini-3.8b", "prefill_32k"), ("phi4-mini-3.8b", "decode_32k"),
    ("mixtral-8x22b", "decode_32k"), ("mamba2-2.7b", "decode_32k"),
    ("zamba2-2.7b", "decode_32k"), ("qwen2-vl-72b", "prefill_32k"),
    ("qwen2-vl-72b", "decode_32k"), ("whisper-tiny", "train_4k"),
    ("whisper-tiny", "prefill_32k"), ("whisper-tiny", "decode_32k"))
MESH_DRYRUN_JOBS = len(MESH_DRYRUN_CELLS)


_T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - _T0,
                      **kw}), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke check failed: {what}")


def cuda_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median milliseconds of `fn` over `runs` CUDA-event timings, after
    a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = 20, runs: int = 7) -> float:
    """Median over `runs` of the milliseconds per call of `calls`
    back-to-back calls between two CUDA events: the device time of a
    kernel whose wrapper's host work per call is shorter than it (one
    timed call, as `cuda_ms` takes, also holds that host work)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of `fn`: the host clock around `calls`
    calls that only enqueue work (the wrapper's checks, allocation and
    launch), with the device idle before and drained after."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def kernel_times(out: dict, fn, kernel: str, calls: int = 20) -> None:
    """Fill `out` with the times of one kernel wrapper `fn` beside the
    phase's `ms` and `bound_ms`: `device_ms` (back-to-back calls between
    two events), `kernel_device_ms` (the device time of the kernels whose
    names hold `kernel`, per call, from the profiler over `calls` calls),
    `host_us` per call, and the bound shares of each."""
    out["device_ms"] = device_ms(fn)
    prof = device_profile(lambda: [fn() for _ in range(calls)],
                          kernels=(kernel,))
    ms, n = prof["kernel_device_ms"][kernel]
    out["kernel_device_ms"] = ms / n if n else "not measured"
    out["kernel_launches_traced"] = n
    out["host_us"] = host_us(fn)
    out["bound_share"] = out["bound_ms"] / out["ms"]
    out["device_bound_share"] = out["bound_ms"] / out["device_ms"]
    if n:
        out["kernel_bound_share"] = out["bound_ms"] / out["kernel_device_ms"]


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """Least ms for `nbytes` moved once and `ops` at `ops_per_s`, and
    which of the two bounds it."""
    by = nbytes / HBM_BYTES_PER_S * 1e3
    op = ops / ops_per_s * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def template_bound_ms(b: int, t: int) -> tuple[float, str]:
    """Least time for (B, T) template scores: each series read once and
    two ratios written, against the float32 operations the function
    needs (de-trend and normalize ~8 per slot; per period a median and a
    k-th smallest, each a linear select at one compare a slot, the
    deviation's subtract and absolute value, and the sum of the kept
    slots)."""
    per_period = t + 2 * t + t + 0.8 * t
    return bound((b * t + b * 2) * 4, b * (8 * t + 3 * per_period),
                 FP32_OPS_PER_S)


def forest_bound_ms(b, f, nf, t, d, k) -> tuple[float, str]:
    """Least time for summed leaf values of NF stacked forests: features,
    forest tables and outputs moved once, against D compares and bit
    packs plus K adds per (row, forest, tree)."""
    return bound(b * f * 4 + nf * t * d * 8 + nf * t * (1 << d) * k * 4
                 + b * nf * k * 4, b * nf * t * (2 * d + k), FP32_OPS_PER_S)


def fleet_series(pop, rows: int, seed: int,
                 slots: int | None = None) -> np.ndarray:
    """(rows, T) series for the daily fleet labeling pass: population
    series resampled with per-VM scale and per-slot jitter, repeated to
    `slots` slots when given."""
    rng = np.random.default_rng(seed)
    base = pop.series[rng.integers(0, len(pop.vms), rows)]
    if slots is not None:
        base = np.tile(base, (1, -(-slots // base.shape[1])))[:, :slots]
    jitter = base * rng.uniform(0.9, 1.1, (rows, 1)) \
        + rng.normal(0.0, 1.0, base.shape)
    return np.clip(jitter, 0.0, 100.0).astype(np.float32)


def template_phase(series: np.ndarray, dev, timed: bool = True,
                   keep_frac: float = 0.8) -> dict:
    """The template kernel against its plain version on one input, with
    both timed and the bound when `timed` (the register path's kernel up
    to its MAX_T slots, the block path's past them)."""
    import torch
    from repro_torch.kernels.template import ops, ref
    x = torch.as_tensor(series, device=dev)
    got = ops.criticality_scores(x, keep_frac)
    want = ref.criticality_scores_ref(x, keep_frac)
    torch.cuda.synchronize()
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "template scores finite")
    check(bool((err <= TEMPLATE_ATOL + TEMPLATE_RTOL * want.abs()).all()),
          f"template kernel within rtol {TEMPLATE_RTOL} atol "
          f"{TEMPLATE_ATOL} of its plain version")
    agree = ((got[:, 0] < 0.72) == (want[:, 0] < 0.72)).float().mean()
    out = {"shape": list(series.shape), "keep_frac": keep_frac,
           "max_abs_err": err.max().item(),
           "max_rel_err": (err / want.abs().clamp(min=1e-12)).max().item(),
           "label_agreement": agree.item()}
    if timed:
        out["ms"] = cuda_ms(lambda: ops.criticality_scores(x, keep_frac))
        out["plain_ms"] = cuda_ms(
            lambda: ref.criticality_scores_ref(x, keep_frac))
        out["bound_ms"], out["bound_by"] = template_bound_ms(*series.shape)
        kernel = "criticality_kernel" if series.shape[1] <= ops.MAX_T \
            else "criticality_block_kernel"
        kernel_times(out, lambda: ops.criticality_scores(x, keep_frac),
                     kernel)
    return out


#: Long series of the template kernel's block path, timed: 30 and 90 days
#: of history (1,440 and 4,320 slots) for a day's fleet labeling batch.
TEMPLATE_LONG_ROWS = 8000
TEMPLATE_LONG_T = (1440, 4320)


def main_path(pop, hist, arrivals, budget_w: float, dev):
    """Label the history on `dev`, train the four forests on the host,
    and serve the arrivals in micro-batches. Returns what the checks
    read."""
    import torch
    from repro_torch.core import criticality
    from repro_torch.core import features as F
    from repro_torch.core.predictor import train_service
    from repro_torch.serve import (PlaneBundle, ResourceVector, ServeConfig,
                                   ServePipeline)
    from repro_torch.sim.telemetry import arrival_batch
    t0 = time.perf_counter()
    labels = criticality.classify(hist.series, device=dev)
    labels_np = labels.cpu().numpy()
    t_label = time.perf_counter() - t0
    aggs = F.subscription_aggregates(hist, labels_np)
    t0 = time.perf_counter()
    svc = train_service(F.build_features(hist, aggs),
                        labels_np.astype(np.int64),
                        F.p95_bucket([v.p95_util for v in hist.vms]))
    t_train = time.perf_counter() - t0
    config = ServeConfig(batch_size=BATCH, planes=PlaneBundle(
        chassis_budget=ResourceVector(watts=budget_w)))
    pipe = ServePipeline.from_history(
        svc, hist, labels_np, n_servers=N_SERVERS, cores_per_server=CORES,
        blades_per_chassis=BLADES, config=config, device=dev)
    batch = arrival_batch(arrivals)
    parts, batch_ms = [], []
    t_serve = time.perf_counter()
    for chunk in micro_batches(batch):
        t0 = time.perf_counter()
        parts.append(pipe.serve(chunk))          # ends in a device fetch
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    t_serve = time.perf_counter() - t_serve
    torch.cuda.synchronize()
    return dict(labels=labels_np, svc=svc, config=config, pipe=pipe,
                batch=batch, parts=parts, batch_ms=batch_ms,
                t_label=t_label, t_train=t_train, t_serve=t_serve)


def leaf_index_probe(x, stacked):
    """Leaf indices through the forest kernel: every tree of the stack
    becomes a one-tree forest whose leaf l holds the value l (K = 1), so
    the kernel's summed output is the leaf index it walked to."""
    import torch
    from repro_torch.kernels.forest import ops
    nf, t, d = stacked.feat_idx.shape
    fi = stacked.feat_idx.reshape(nf * t, 1, d).contiguous()
    thr = stacked.thr.reshape(nf * t, 1, d).contiguous()
    leaf = torch.arange(1 << d, dtype=torch.float32, device=x.device) \
        .expand(nf * t, 1, 1 << d)[..., None].contiguous()
    return ops.forest_sums(x, fi, thr, leaf)[..., 0] \
        .reshape(x.shape[0], nf, t).round().long()


def forest_phase(x, stacked, svc=None) -> dict:
    """The forest kernel against its plain version on one feature batch:
    leaf indices exact (and equal to `leaf_index_np` when `svc` is
    given), the sums over T trees within FOREST_ATOL once divided by
    T — the RF mean the gate reads, and the bar tests/test_kernels.py
    holds the tiled Pallas kernel to — and the sums bit-equal to
    `ref.forest_sums_lanes`, the kernel's summation order emulated in
    torch (the plain version adds in the card's reduction order; sums
    near 48 differ by a few float32 ulps, ~4e-6 each)."""
    import torch
    from repro_torch.kernels.forest import ops, ref
    got = ops.forest_sums(x, *stacked)
    want = ref.forest_sums_ref(x, *stacked)
    nf, t, d = stacked.feat_idx.shape
    plan = ops.launch_plan(x.shape[0], x.shape[1], nf, t, d,
                           stacked.leaf.shape[-1])
    lanes = ref.forest_sums_lanes(x, *stacked, tile=plan["tile"],
                                  lanes=plan["lanes"])
    idx = leaf_index_probe(x, stacked)
    idx_ref = ref.leaf_index_ref(x, stacked.feat_idx, stacked.thr)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(bool(torch.equal(idx, idx_ref)), "forest kernel leaf indices equal "
          "the plain version's")
    if svc is not None:
        xn = x.cpu().numpy()
        forests = (svc.criticality, svc.p95.stage1, svc.p95.low,
                   svc.p95.high)
        for j, f in enumerate(forests):
            check(np.array_equal(idx[:, j].cpu().numpy(),
                                 f.leaf_index_np(xn)),
                  "forest kernel leaf indices equal leaf_index_np")
    check(err / t <= FOREST_ATOL,
          f"forest sums / T within {FOREST_ATOL}: {err / t}")
    check(bool(torch.equal(got, lanes)), "forest sums bit-equal to the "
          "emulated summation order (ref.forest_sums_lanes)")
    return {"shape": [x.shape[0], *stacked.leaf.shape],
            "max_abs_err": err, "max_abs_err_per_tree": err / t,
            "leaf_indices_equal": True, "equals_lane_emulation": True,
            "plan": {k: v for k, v in plan.items() if k != "grid"},
            "blocks": plan["grid"][0] * plan["grid"][1]}


def device_profile(fn, traced=None, kernels=()) -> dict:
    """Host wall of one unprofiled call of `fn` against the device time
    the profiler traces in a call of `traced` (default `fn` again): the
    busy and idle share, kernel launches, the top kernels, and the
    device ms and count of the kernels whose names hold a string of
    `kernels`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # the card's activity alone: it holds the kernels and the runtime's
    # launch calls, and skips recording every host operator, which costs
    # more than the launch it wraps on the long runs
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (traced or fn)()
        torch.cuda.synchronize()
    # the raw trace events, summed by name: `key_averages()` first builds
    # a Python object and tree for every event (two a launch), which took
    # longer than the profiled run itself on the long serving runs
    per_name, launches = {}, 0          # device name -> [ns, count]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                acc = per_name.setdefault(e.name(), [0, 0])
                acc[0] += e.duration_ns()
                acc[1] += 1
        elif e.name() == "cudaLaunchKernel":
            launches += 1
    busy_ms = sum(ns for ns, _ in per_name.values()) / 1e6
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:6]
    named = {k: [sum(ns for n, (ns, _) in per_name.items() if k in n) / 1e6,
                 sum(c for n, (_, c) in per_name.items() if k in n)]
             for k in kernels}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms or "not measured",
            "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms
            else "not measured",
            "launches": launches,
            "top_device_ms": [[n[:48], ns / 1e6, c] for n, (ns, c) in top],
            "kernel_device_ms": named}


def serve_profile(pipe, batch_a, batch_b) -> dict:
    """Where a served micro-batch's time goes: host wall of `batch_a`,
    unprofiled, against the device time the profiler traces while
    `batch_b`, a batch like it, is served."""
    out = device_profile(lambda: pipe.serve(batch_a),
                         lambda: pipe.serve(batch_b))
    out["launches_per_arrival"] = out.pop("launches") / len(batch_b)
    return out


def flash_ops(b, h, lq, lk, d) -> float:
    """The QK and PV products of the (q, k) pairs the causal mask keeps
    (2 D operations each for QK^T and for PV); rows before the first key
    (Lk < Lq) keep none."""
    pairs = sum(max(0, min(lk, lk - lq + i + 1)) for i in range(lq))
    return 4 * d * pairs * b * h


def flash_bound_ms(b, h, lq, lk, d, itemsize,
                   hkv=None) -> tuple[float, str]:
    """q, k, v read once and o written once (k and v at `hkv` heads, h by
    default), against `flash_ops` on the bf16 tensor cores."""
    hkv = h if hkv is None else hkv
    return bound(b * (2 * h * lq + 2 * hkv * lk) * d * itemsize,
                 flash_ops(b, h, lq, lk, d), BF16_OPS_PER_S)


def ssd_ops(b, l, h, p, n, chunk=128) -> float:
    """The dual form's products at the reference's chunk (per chunk and
    head: C B^T 2Q^2N, the masked-decay product 2Q^2P, C S^T and the
    state update 2QPN each)."""
    nc = -(-l // chunk)
    return b * h * nc * (2 * chunk * chunk * (n + p) + 4 * chunk * p * n)


def ssd_bound_ms(b, l, h, p, n, itemsize) -> tuple[float, str]:
    """x read and y written once, dt, B, C, a, d read once, against
    `ssd_ops` on the bf16 tensor cores."""
    nbytes = 2 * b * l * h * p * itemsize + b * l * h * 4 \
        + 2 * b * l * n * itemsize + 2 * h * 4
    return bound(nbytes, ssd_ops(b, l, h, p, n), BF16_OPS_PER_S)


def rates(out: dict, ops: float) -> None:
    """Achieved TFLOP/s of the function's operations and the roofline
    share bound_ms / ms, from a phase's own time (one call, and device
    time) and bound."""
    out["tflops"] = ops / (out["ms"] * 1e-3) / 1e12
    out["bound_share"] = out["bound_ms"] / out["ms"]
    out["device_tflops"] = ops / (out["device_ms"] * 1e-3) / 1e12
    out["device_bound_share"] = out["bound_ms"] / out["device_ms"]


def flash_phase(b: int, l: int, seed: int, dev) -> dict:
    """The flash kernel against its plain version at Zamba2's attention
    shape (B, 32 heads, L, 80), causal, in float32 and bf16 (the path's
    dtype); bf16 timed beside the plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, 32, l, 80)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    out = {"shape": list(shape), "causal": True}
    # Lk = L, and one causal case at Lk = L / 2 < Lq, whose first L / 2
    # rows see no key and take the reference kernel's value from the kernel
    for lk, tag in ((l, ""), (l // 2, "lk_below_lq_")):
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            qd, kd, vd = q.to(dt), k[:, :, :lk].to(dt), v[:, :, :lk].to(dt)
            got = ops.flash_attention(qd, kd, vd, causal=True)
            want = ref.attention_kernel_ref(qd, kd, vd, causal=True)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(bool(torch.isfinite(got).all()), "flash output finite")
            check(err <= FLASH_ATOL[name], f"flash kernel {name} at Lk {lk}"
                  f", Lq {l} within {FLASH_ATOL[name]} of its plain "
                  f"version: {err}")
            out[f"max_abs_err_{tag}{name}"] = err
    qd, kd, vd = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out["max_abs_err"] = out["max_abs_err_bfloat16"]
    out["ms"] = cuda_ms(lambda: ops.flash_attention(qd, kd, vd))
    out["plain_ms"] = cuda_ms(lambda: ref.attention_ref(qd, kd, vd))
    # the library yardstick: Lq == Lk, so SDPA's top-left causal mask is
    # the kernel's end-aligned one
    out["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, is_causal=True))
    out["device_ms"] = device_ms(lambda: ops.flash_attention(qd, kd, vd))
    out["library_device_ms"] = device_ms(
        lambda: F.scaled_dot_product_attention(qd, kd, vd, is_causal=True))
    out["bound_ms"], out["bound_by"] = flash_bound_ms(b, 32, l, l, 80, 2)
    out["bound_peaks"] = BF16_PEAKS
    rates(out, flash_ops(b, 32, l, l, 80))
    return out


#: Flash shapes no model path gives the kernel, which the reference's
#: wrapper takes: (B, Hq, Hkv, Lq, Lk, D, window), causal, bf16 —
#: Zamba2's heads at Lk 200 < Lq 512 (312 rows see no key), Zamba2's
#: prefill at head dim 100, which the wrapper pads to 104, and d_model
#: 4,096 in heads of 256 (Gemma 7B's head dim; the Hopper kernel's 256
#: tiling) and of 320 (past the tilings: the kernel that splits D).
FLASH_GAPS = {"lk_below_lq": (8, 32, 32, 512, 200, 80, None),
              "d100": (8, 32, 32, 512, 512, 100, None),
              "d256": (8, 16, 16, 512, 512, 256, None),
              "d320": (8, 16, 16, 512, 512, 320, None)}


def flash_gaps(seed: int, dev) -> dict:
    """The flash kernel at FLASH_GAPS against its plain version
    (`attention_kernel_ref`), timed with the plain version, the bound and,
    where one call computes the same function, SDPA (at Lk < Lq SDPA's
    causal mask is top-left aligned and leaves the rows before the first
    key NaN: no library call)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = {}
    for name, (b, hq, hkv, lq, lk, d, window) in FLASH_GAPS.items():
        q = torch.randn((b, hq, lq, d), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, hkv, lk, d), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        rep = hq // hkv
        kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)

        def call():
            return ops.flash_attention(q, k, v, causal=True, window=window)
        got = call()
        want = ref.attention_kernel_ref(q, kr, vr, causal=True,
                                        window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"flash {name} finite")
        check(err <= FLASH_ATOL["bfloat16"], f"flash {name} within "
              f"{FLASH_ATOL['bfloat16']} of its plain version: {err}")
        out = {"shape": [b, hq, hkv, lq, lk, d], "causal": True,
               "window": window, "max_abs_err": err,
               "no_key_rows": ref.no_key_rows(lq, lk, True)}
        out["ms"] = cuda_ms(call)
        out["plain_ms"] = cuda_ms(lambda: ref.attention_kernel_ref(
            q, kr, vr, causal=True, window=window))
        out["library_ms"] = None
        if lq == lk:
            def sdpa():
                return F.scaled_dot_product_attention(q, kr, vr,
                                                      is_causal=True)
            out["library_ms"] = cuda_ms(sdpa)
            out["library_device_ms"] = device_ms(sdpa)
        out["device_ms"] = device_ms(call)
        out["bound_ms"], out["bound_by"] = flash_bound_ms(b, hq, lq, lk, d,
                                                          2, hkv)
        out["bound_peaks"] = BF16_PEAKS
        rates(out, flash_ops(b, hq, lq, lk, d))
        # where a call's device time goes: the main kernel, the rows
        # with no key, the wrapper's pads and slice (per call, 20 calls)
        prof = device_profile(lambda: [call() for _ in range(20)],
                              kernels=("flash_kernel_bf16",
                                       "flash_kernel_wide",
                                       "no_key_rows_kernel"))
        out["profile_per_call"] = {
            "device_busy_ms": prof["device_busy_ms"] / 20,
            "launches": prof["launches"] / 20,
            "kernel_device_ms": {k: ms / 20 for k, (ms, _) in
                                 prof["kernel_device_ms"].items()},
            "top_device_ms": [[n, ms / 20, c / 20]
                              for n, ms, c in prof["top_device_ms"]]}
        res[name] = out
    return res


def ssd_inputs(b: int, l: int, seed: int, dev):
    """Zamba2's SSD operands at (B, L): 80 heads of 64, state 64; dt the
    softplus of a unit normal (dt_bias is 0 at init), a = -linspace(1,
    16) as the model's a_log gives it, D = 1."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, p, n = 80, 64, 64
    x = torch.randn((b, l, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, h), generator=gen, device=dev))
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    bm = torch.randn((b, l, n), generator=gen, device=dev)
    cm = torch.randn((b, l, n), generator=gen, device=dev)
    return x, dt, a, bm, cm, torch.ones(h, device=dev)


def ssd_phase(b: int, l: int, seed: int, dev, exact: bool) -> dict:
    """The SSD kernel against its plain version (the chunked dual form at
    the wrapper's chunk) in float32 and bf16 (the path's dtype), and in
    float32 against the exact recurrence when `exact`; bf16 timed."""
    import torch
    from repro_torch.kernels.ssd import ops, ref
    x, dt, a, bm, cm, d = ssd_inputs(b, l, seed, dev)
    ch = min(ops.CHUNK, max(l, 8))
    out = {"shape": [b, l, 80, 64, 64]}
    got = ops.ssd(x, dt, a, bm, cm, d)
    want = ref.ssd_chunked(x, dt, a, bm, cm, d, chunk=ch)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()), "SSD output finite")
    check(err <= SSD_ATOL, f"SSD kernel float32 within {SSD_ATOL} of its "
          f"plain version: {err}")
    out["max_abs_err_float32"] = err
    if exact:
        y, _ = ref.ssd_ref(x, dt, a, bm, cm, d)
        err = (got - y).abs().max().item()
        check(err <= SSD_ATOL, f"SSD kernel within {SSD_ATOL} of the "
              f"recurrence: {err}")
        out["max_abs_err_vs_recurrence"] = err
    xb, bb, cb = x.bfloat16(), bm.bfloat16(), cm.bfloat16()
    got = ops.ssd(xb, dt, a, bb, cb, d).float()
    want = ref.ssd_chunked(xb, dt, a, bb, cb, d, chunk=ch).float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    check(bool((err <= SSD_BF16_ATOL + SSD_BF16_RTOL * want.abs()).all()),
          f"SSD kernel bf16 within {SSD_BF16_ATOL} + {SSD_BF16_RTOL} "
          "relative of its plain version")
    out["max_abs_err_bfloat16"] = out["max_abs_err"] = err.max().item()
    # the model's operands: x, B and C as views of one conv output of
    # rows H P + 2N, read in place; bit-equal to the contiguous call, and
    # a repeated call bit-equal to the first
    buf = torch.cat([xb.reshape(b, l, -1), bb, cb], -1)
    xv, bv, cv = torch.split(buf, [xb.shape[2] * xb.shape[3], bb.shape[-1],
                                   cb.shape[-1]], dim=-1)
    xv = xv.reshape(xb.shape)
    one = ops.ssd(xv, dt, a, bv, cv, d)
    two = ops.ssd(xv, dt, a, bv, cv, d)
    got = ops.ssd(xb, dt, a, bb, cb, d)
    torch.cuda.synchronize()
    check(torch.equal(one, got), "SSD kernel on strided views bit-equal "
          "to the contiguous call")
    check(torch.equal(one, two), "SSD kernel repeated call bit-equal")
    out["strided_bit_equal"] = out["repeat_bit_equal"] = True
    out["ms"] = cuda_ms(lambda: ops.ssd(xb, dt, a, bb, cb, d))
    out["device_ms"] = device_ms(lambda: ops.ssd(xb, dt, a, bb, cb, d))
    out["strided_ms"] = cuda_ms(lambda: ops.ssd(xv, dt, a, bv, cv, d))
    out["strided_device_ms"] = device_ms(
        lambda: ops.ssd(xv, dt, a, bv, cv, d))
    out["plain_ms"] = cuda_ms(
        lambda: ref.ssd_chunked(xb, dt, a, bb, cb, d, chunk=ch))
    out["bound_ms"], out["bound_by"] = ssd_bound_ms(b, l, 80, 64, 64, 2)
    out["bound_peaks"] = BF16_PEAKS
    rates(out, ssd_ops(b, l, 80, 64, 64))
    return out


#: Edge shapes of the bf16 tensor-core kernels that the prefill shape
#: never reaches. Flash: (B, Hq, Hkv, Lq, Lk, D, causal, window) — ragged
#: Lq, Lk > Lq, a window, GQA rep 2, D 16, 40 (not a multiple of 16) and
#: 128, non-causal; then the families' shapes: mixtral's heads (GQA rep
#: 6, its window of 4,096 not biting at 512), that window biting over
#: 5,000 keys, whisper's cross-attention over 1,500 frames, and a
#: non-causal Lk < Lq; then the edges of the Hopper kernel's tiling (128
#: query rows a block, two warpgroups of 64, 128-key tiles): Lq 300, not
#: a multiple of 128, at GQA rep 6 and D 128; a window of 64, narrower
#: than a key tile, at L 512; D 40 and D 16 padded to wgmma's depth of
#: 16 by the maps' zero fill; Lq 64 over Lk 1,500 non-causal, a block
#: whose second warpgroup has no row; causal at Lk < Lq (GQA rep 6, D
#: 128, with a window of 16 too), whose first Lq - Lk rows see no key;
#: D 20 and 100, which the wrapper pads to 24 and 104; then head dims
#: past 128: 192 and 256 (the tilings that read Q in place; with a
#: window, and at Lk < Lq), 136 (padded to 192) over 1,500 keys, and 320
#: (the kernel that splits D). SSD: (B, L, H, P, N) — ragged L,
#: N 128, P 16, and P, N the wrapper pads to multiples of 8; then the
#: Hopper kernel's work tiles (chunks of 64 steps, 2 heads): a hand-over
#: chain of 128 chunks (1 x 8,192 at 4 heads), a partial head group (81
#: heads), L 100 (two chunks, the second ragged) and L 40 (shorter than
#: one chunk); then P past 64 (two slices; 96, a partial one) with N 256
#: and 136 (four atoms), and N 320 (the state in device memory). Cases
#: past D 128, P 64 or N 128 run in float32 too, at its bar.
FLASH_EDGES = [(2, 4, 2, 300, 300, 80, True, None),
               (2, 4, 2, 300, 700, 80, True, None),
               (2, 4, 2, 512, 512, 80, True, 128),
               (2, 4, 2, 300, 300, 16, True, None),
               (2, 4, 2, 300, 300, 40, True, None),
               (2, 4, 2, 300, 700, 128, True, 200),
               (2, 4, 2, 300, 700, 128, False, None),
               (2, 48, 8, 512, 512, 128, True, 4096),
               (1, 48, 8, 300, 5000, 128, True, 4096),
               (2, 6, 6, 64, 1500, 64, False, None),
               (2, 6, 6, 700, 300, 64, False, None),
               (1, 12, 2, 300, 300, 128, True, None),
               (2, 4, 2, 512, 512, 80, True, 64),
               (2, 4, 2, 300, 300, 40, False, None),
               (2, 4, 2, 300, 700, 16, True, 100),
               (2, 4, 4, 64, 1500, 80, False, None),
               (1, 12, 2, 300, 200, 128, True, None),
               (1, 12, 2, 700, 72, 128, True, 16),
               (2, 4, 2, 300, 700, 20, True, 128),
               (2, 4, 2, 300, 300, 100, True, None),
               (2, 4, 2, 300, 300, 192, True, None),
               (2, 4, 2, 300, 700, 256, True, 128),
               (1, 12, 2, 300, 200, 256, True, None),
               (2, 4, 4, 64, 1500, 136, False, None),
               (2, 4, 2, 300, 300, 320, True, None)]
SSD_EDGES = [(2, 200, 80, 64, 64), (2, 200, 4, 64, 128),
             (2, 200, 4, 16, 64), (2, 300, 3, 40, 20),
             (1, 8192, 4, 64, 64), (2, 512, 81, 64, 64),
             (2, 100, 80, 64, 64), (2, 40, 80, 64, 64),
             (2, 200, 4, 128, 256), (2, 300, 3, 96, 136),
             (1, 200, 2, 160, 320)]


def edge_sweep(seed: int, dev) -> dict:
    """The bf16 flash and SSD kernels against their plain versions at
    FLASH_EDGES and SSD_EDGES, at the phases' unchanged bars; SSD inputs
    at Zamba2's strong decays (a = -linspace(1, 16), dt = softplus of a
    unit normal)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd import ref as sref
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    flash = []
    for b, hq, hkv, lq, lk, d, causal, window in FLASH_EDGES:
        q32 = randn(b, hq, lq, d)
        k32, v32 = randn(b, hkv, lk, d), randn(b, hkv, lk, d)
        rep = hq // hkv
        case = [b, hq, hkv, lq, lk, d, causal, window]
        rec = {"case": case}
        for dt in (torch.bfloat16, torch.float32)[:1 + (d > 128)]:
            name = str(dt).split(".")[1]
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            got = fops.flash_attention(q, k, v, causal=causal, window=window)
            want = fref.attention_kernel_ref(q, k.repeat_interleave(rep, 1),
                                             v.repeat_interleave(rep, 1),
                                             causal=causal, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(bool(torch.isfinite(got).all()),
                  f"flash edge {case} {name} finite")
            check(err <= FLASH_ATOL[name], f"flash edge {case} {name} "
                  f"within {FLASH_ATOL[name]} of its plain version: {err}")
            rec["max_abs_err" if dt == torch.bfloat16
                else "max_abs_err_float32"] = err
        flash.append(rec)
    ssd = []
    for b, l, h, p, n in SSD_EDGES:
        x32 = randn(b, l, h, p)
        dt = torch.nn.functional.softplus(randn(b, l, h))
        a = -torch.linspace(1.0, 16.0, h, device=dev)
        bm32, cm32 = randn(b, l, n), randn(b, l, n)
        d = torch.ones(h, device=dev)
        x, bm, cm = x32.bfloat16(), bm32.bfloat16(), cm32.bfloat16()
        ch = min(sops.CHUNK, max(l, 8))
        got = sops.ssd(x, dt, a, bm, cm, d).float()
        want = sref.ssd_chunked(x, dt, a, bm, cm, d, chunk=ch).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        case = [b, l, h, p, n]
        check(bool(torch.isfinite(got).all()), f"SSD edge {case} finite")
        check(bool((err <= SSD_BF16_ATOL + SSD_BF16_RTOL * want.abs()).all()),
              f"SSD edge {case} within {SSD_BF16_ATOL} + {SSD_BF16_RTOL} "
              "relative of its plain version")
        rec = {"case": case, "max_abs_err": err.max().item(),
               "max_abs_y": want.abs().max().item()}
        if p > 64 or n > 128:
            got = sops.ssd(x32, dt, a, bm32, cm32, d)
            want = sref.ssd_chunked(x32, dt, a, bm32, cm32, d, chunk=ch)
            torch.cuda.synchronize()
            e32 = (got - want).abs().max().item()
            check(e32 <= SSD_ATOL, f"SSD edge {case} float32 within "
                  f"{SSD_ATOL} of its plain version: {e32}")
            rec["max_abs_err_float32"] = e32
        ssd.append(rec)
    return {"flash": flash, "ssd": ssd}


#: SSD past Zamba2's widths (P 64, N 64), bf16, B 8 x 512: mamba2-2.7b's
#: d_inner of 5,120 as 40 heads of P 128 with N 256 (the Hopper kernel's
#: two P slices and four atoms of N), and the same at N 320 (the kernel
#: that keeps the state in device memory); Zamba2's decays.
SSD_WIDE = {"p128_n256": (8, 512, 40, 128, 256),
            "p128_n320": (8, 512, 40, 128, 320)}


def ssd_widths(seed: int, dev) -> dict:
    """The SSD kernel at SSD_WIDE against its plain version at the bf16
    bar, on the model's strided views bit-equal to the contiguous call
    and to a repeat; timed beside the plain version and the bound."""
    import torch
    from repro_torch.kernels.ssd import ops, ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = {}
    for name, (b, l, h, p, n) in SSD_WIDE.items():
        buf = torch.randn((b, l, h * p + 2 * n), generator=gen,
                          device=dev).bfloat16()
        xs, bm, cm = torch.split(buf, [h * p, n, n], dim=-1)
        xv = xs.reshape(b, l, h, p)
        x = xv.contiguous()
        dt = torch.nn.functional.softplus(
            torch.randn((b, l, h), generator=gen, device=dev))
        a = -torch.linspace(1.0, 16.0, h, device=dev)
        d = torch.ones(h, device=dev)
        ch = min(ops.CHUNK, max(l, 8))
        got = ops.ssd(x, dt, a, bm, cm, d)
        want = ref.ssd_chunked(x, dt, a, bm, cm, d, chunk=ch).float()
        one, two = ops.ssd(xv, dt, a, bm, cm, d), ops.ssd(xv, dt, a, bm, cm, d)
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        check(bool(torch.isfinite(got).all()), f"SSD {name} finite")
        check(bool((err <= SSD_BF16_ATOL + SSD_BF16_RTOL * want.abs()).all()),
              f"SSD {name} within {SSD_BF16_ATOL} + {SSD_BF16_RTOL} "
              "relative of its plain version")
        check(torch.equal(one, got) and torch.equal(one, two),
              f"SSD {name} on strided views bit-equal to the contiguous "
              "call and to a repeat")
        out = {"shape": [b, l, h, p, n], "plan": ops.plan(p, n, x.dtype),
               "max_abs_err": err.max().item(),
               "max_abs_y": want.abs().max().item(),
               "strided_bit_equal": True, "repeat_bit_equal": True}
        out["ms"] = cuda_ms(lambda: ops.ssd(x, dt, a, bm, cm, d))
        out["device_ms"] = device_ms(lambda: ops.ssd(x, dt, a, bm, cm, d))
        out["strided_device_ms"] = device_ms(
            lambda: ops.ssd(xv, dt, a, bm, cm, d))
        out["plain_ms"] = cuda_ms(
            lambda: ref.ssd_chunked(x, dt, a, bm, cm, d, chunk=ch))
        out["library_ms"] = None
        out["bound_ms"], out["bound_by"] = ssd_bound_ms(b, l, h, p, n, 2)
        out["bound_peaks"] = BF16_PEAKS
        rates(out, ssd_ops(b, l, h, p, n))
        res[name] = out
    return res



#: Edge shapes of the forest and template kernels. Forest: (B, NF, T, D,
#: K) at F = 18 — one row, a ragged batch, stacks over the 48 KB of
#: shared memory (T = 100 and 256 at D = 6), depths 1 and 8, K = 1, 4 and
#: 10, and a stack of 400 trees at depth 12 that takes two tree tiles.
#: Template: T = 48, 96, 480 and 1,008 slots, 1,056, the block path's
#: first (at keep_frac 0.6 too), and 6,192, the first whose medians take
#: the digit select (labels equal there).
FOREST_EDGES = [(1, 4, 48, 6, 2), (300, 4, 48, 6, 2), (256, 4, 100, 6, 2),
                (256, 4, 256, 6, 2), (256, 4, 48, 1, 2), (256, 4, 48, 8, 2),
                (256, 4, 48, 6, 1), (256, 4, 48, 6, 4), (256, 4, 48, 6, 10),
                (256, 1, 400, 12, 2)]
TEMPLATE_EDGES = (48, 96, 480, 1008, 1056)
TEMPLATE_DIGIT_T = 6192


def template_edge_rows(pop, t: int, rng) -> np.ndarray:
    """(264, T) rows: 128 population series tiled to T slots with jitter,
    128 uniform rows, and at the end a constant row (the std floor), an
    all-zero row (the de-trend base floor), a row with one zero day, and
    five rows of ties (values from {0, 50, 100}; a constant 25 with a
    step)."""
    base = np.tile(pop.series[rng.integers(0, len(pop.vms), 128)],
                   (1, -(-t // pop.series.shape[1])))[:, :t]
    tiled = np.clip(base + rng.normal(0, 1, base.shape), 0, 100)
    uniform = rng.uniform(0, 100, (128, t))
    zero_day = rng.uniform(0, 100, t)
    zero_day[t // 2:t // 2 + 48] = 0.0
    ties = rng.choice([0.0, 50.0, 100.0], (4, t))
    step = np.full(t, 25.0)
    step[t // 2:] = 50.0
    return np.concatenate([tiled, uniform, np.full((1, t), 25.0),
                           np.zeros((1, t)), zero_day[None], ties,
                           step[None]]).astype(np.float32)


def placement_edge_sweep(pop, seed: int, dev) -> dict:
    """The forest and template kernels against their plain versions at
    FOREST_EDGES and TEMPLATE_EDGES, at the main-path bars: leaf indices
    exact, forest sums within FOREST_ATOL per tree and bit-equal to the
    emulated summation order, template scores within TEMPLATE_RTOL /
    TEMPLATE_ATOL (and the special rows at T = 240 too)."""
    import torch
    from repro_torch.serve.inference import PackedForest
    rng = np.random.default_rng(seed)
    forest = []
    for b, nf, t, d, k in FOREST_EDGES:
        x = torch.as_tensor(rng.normal(0, 1, (b, 18)), dtype=torch.float32,
                            device=dev)
        stack = PackedForest(
            torch.as_tensor(rng.integers(0, 18, (nf, t, d)),
                            dtype=torch.int32, device=dev),
            torch.as_tensor(rng.normal(0, 1, (nf, t, d)),
                            dtype=torch.float32, device=dev),
            torch.as_tensor(rng.normal(0, 1, (nf, t, 1 << d, k)),
                            dtype=torch.float32, device=dev))
        r = forest_phase(x, stack)
        r["case"] = [b, nf, t, d, k]
        forest.append(r)
    template = []
    for t in TEMPLATE_EDGES + (240,):
        template.append(template_phase(template_edge_rows(pop, t, rng), dev,
                                       timed=False))
    template.append(template_phase(template_edge_rows(pop, 1056, rng), dev,
                                   timed=False, keep_frac=0.6))
    digits = template_phase(template_edge_rows(pop, TEMPLATE_DIGIT_T, rng),
                            dev, timed=False)
    check(digits["label_agreement"] == 1.0,
          f"template labels equal at T = {TEMPLATE_DIGIT_T} (the medians' "
          "digit select)")
    template.append(digits)
    return {"forest": forest, "template": template}


#: SASS instructions counted in each kernel: Ampere-style tensor-core
#: MMAs, Hopper's warpgroup MMAs, and TMA tile loads.
SASS_OPS = ("HMMA", "HGMMA", "UTMALDG")


def sass_mma_counts(lib: str) -> dict:
    """The SASS_OPS instructions in each kernel of the built library's
    SASS, by `cuobjdump --dump-sass`: {kernel: {op: count}}."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" \
        / "cuobjdump"
    sass = subprocess.run([str(tool), "--dump-sass", lib],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", ln):
                    counts[fn][op] += 1
    return counts


def lm_path(seed: int, dev) -> dict:
    """LM serving of Zamba2-2.7B at full width: the batch prefill through
    the kernels and `serve_batch` through the cache path, each with the
    launch counts at 0 just before it and read just after; then the
    checks and the profiles."""
    import torch
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _tensors(params))
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    prefill = make_prefill_step(cfg, impl="cuda")
    prefill(params, batch)                       # cuBLAS and allocator warm-up
    torch.cuda.synchronize()

    reset_launches()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_launches = dict(KERNEL_LAUNCHES)
    reset_launches()
    trace = {}
    tokens = serve_batch(cfg, params, prompts[:, :LM_SERVE_PROMPT], LM_GEN,
                         trace=trace)
    serve_launches = dict(KERNEL_LAUNCHES)
    # the kernel prefill of serve_batch's prompts, for the comparison
    short = prefill(params, {"tokens": batch["tokens"][:, :LM_SERVE_PROMPT]})

    groups = cfg.n_layers // cfg.attn_every
    check(prefill_launches["flash_attention"] == groups,
          f"flash launches {prefill_launches['flash_attention']} == "
          f"{groups} per prefill")
    check(prefill_launches["ssd"] == cfg.n_layers,
          f"SSD launches {prefill_launches['ssd']} == {cfg.n_layers} per "
          "prefill")
    lf = short.float()
    pl = trace["prompt_logits"].float()
    check(bool(torch.isfinite(logits.float()).all()
               and torch.isfinite(lf).all() and torch.isfinite(pl).all()),
          "prefill and cache-path logits finite")
    check(tokens.shape == (LM_BATCH, LM_GEN), "serve_batch token shape")
    gap = (lf - pl).abs()
    check(bool((gap <= LM_ATOL + LM_RTOL * pl.abs()).all()),
          f"prefill within atol {LM_ATOL} rtol {LM_RTOL} of the cache path "
          f"after the last prompt token: max gap {gap.max().item()}")
    # a row's argmax can only move if its top-2 margin is at most twice
    # the largest change of one of its logits
    top2 = lf.topk(2, -1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    row_gap = gap.amax(-1).cpu().numpy()
    decided = margin > 2 * row_gap
    first = tokens[:, 0]
    agree = first == lf.argmax(-1).cpu().numpy()
    check(decided.any(), "some row's margin exceeds twice its logit gap")
    check(bool(agree[decided].all()), "the first generated token equals the "
          "prefill argmax wherever the margin exceeds twice the gap")

    # the whole forward through the kernels against the plain versions
    h_cuda = T.forward(cfg, params, batch, impl="cuda").float()
    h_plain = T.forward(cfg, params, batch, impl="chunked").float()
    torch.cuda.synchronize()
    fwd_gap = (h_cuda - h_plain).abs()
    check(bool(torch.isfinite(h_cuda).all()), "kernel forward finite")
    fwd_max = fwd_gap.max().item()
    check(bool((fwd_gap <= LM_ATOL + LM_RTOL * h_plain.abs()).all()),
          f"kernel forward within atol {LM_ATOL} rtol {LM_RTOL} of the "
          f"plain forward: max {fwd_max}")
    plain = make_prefill_step(cfg, impl="chunked")
    del h_cuda, h_plain, fwd_gap

    out = {"arch": cfg.name, "params": n_params, "init_s": init_s,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
           "serve_prompt": LM_SERVE_PROMPT,
           "prefill_launches": prefill_launches,
           "serve_launches": serve_launches,
           "prefill_ms": cuda_ms(lambda: prefill(params, batch), runs=5),
           "plain_prefill_ms": cuda_ms(lambda: plain(params, batch), runs=5),
           "prompt_decode_s": trace["prompt_s"], "gen_s": trace["gen_s"],
           "decode_tokens_per_s": LM_BATCH * LM_GEN / trace["gen_s"],
           "prefill_vs_cache_max_gap": gap.max().item(),
           "rows_decided": int(decided.sum()),
           "first_token_agrees": agree.tolist(),
           "margins": margin.tolist(),
           "forward_vs_plain_max_gap": fwd_max}
    # one decode step at the end of the run's cache length, and one
    # prefill, with their device busy time and top kernels
    cache = T.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, device=dev)
    step = make_serve_step(cfg)
    cur = {"tokens": torch.as_tensor(tokens[:, -1:], device=dev),
           "cache_index": LM_PROMPT + LM_GEN - 1}
    out["decode_step_profile"] = device_profile(
        lambda: step(params, cache, cur))
    # the kernels' device time inside a prefill: [ms, launches] each
    out["prefill_profile"] = device_profile(
        lambda: prefill(params, batch),
        kernels=("flash_kernel_bf16", "ssd_kernel_bf16"))
    return out


#: lm_families: the moe, audio and vlm families at full width, one model
#: at a time, each freed before the next. (arch, layers kept (None:
#: whole), prefill (B, L), serve (B, L, generated)). Depth is cut to fit
#: one 80 GB card: mixtral-8x22b 8 of 56 layers (~40.9 GB of bf16
#: weights), qwen2-vl-72b 4 of 80 (~12 GB), arctic-480b 1 of 35 (128
#: experts and the dense residual, ~28 GB); whisper-tiny whole (4 + 4
#: layers, 1,500 frames). The prefill is counted, timed and held against
#: the plain forward; serve_batch's prompt logits are held against a
#: kernel prefill of the same prompts (no frames but the zero frames
#: serve_batch primes from, no patches), for MoE layer by layer
#: (`moe_layerwise`). Mixtral's prefill (8 x 512: 8,192
#: assignments) runs under the capacity and can drop; its serve prompts
#: (4 x 512: 4,096) are dropless in the prefill as in the cache path,
#: which always is.
FAMILY_RUNS = (("mixtral-8x22b", 8, (8, 512), (4, 512, 32)),
               ("whisper-tiny", None, (8, 64), (8, 64, 32)),
               ("qwen2-vl-72b", 4, (8, 512), (8, 512, 32)),
               ("arctic-480b", 1, (4, 64), (4, 64, 16)))
#: The vision stub's patch embeddings per prompt (the reference's
#: N_PATCHES, src/repro/launch/steps.py:26).
N_PATCHES = 256


class RoutingProbe:
    """While entered, records every MoE call of the port's transformer:
    the router's float32 logits (T, E), the expert ids (T, k) and which
    assignments were kept (T, k), by wrapping `transformer.moe_apply`
    (one call holds all its tokens: every call here is under the dispatch
    chunk). It adds a router pass a call, so no counted or timed run is
    probed."""

    def __init__(self):
        self.records = []

    def __enter__(self):
        from repro_torch.models import moe
        from repro_torch.models import transformer as T
        self._orig = orig = T.moe_apply

        def recording(p, x, cfg, capacity_factor=1.25,
                      dispatch_chunk=moe.DISPATCH_CHUNK):
            r = moe.route(p, x.reshape(-1, x.shape[-1]), cfg,
                          capacity_factor)
            self.records.append((r.logits, r.expert_ids,
                                 r.keep.view(r.expert_ids.shape)))
            return orig(p, x, cfg, capacity_factor, dispatch_chunk)
        T.moe_apply = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as T
        T.moe_apply = self._orig


def routing_flips(test, base, n_experts: int, what: str):
    """Tokens whose routing differs between two runs of the same layers
    (`RoutingProbe` records, call for call): `flipped`, the top-k expert
    set differs; `displaced`, the set is equal but another assignment was
    dropped (a flip earlier in the flat order moved the capacity). A flip
    must be a near tie: the token's k-th minus (k+1)-th logit of `base`
    at most twice the largest gap between its two rows of logits (the
    check fails otherwise). Returns the two (T,) masks and per-layer
    counts."""
    import torch
    flipped = displaced = None
    layers = []
    for (lt, it, kt), (lb, ib, kb) in zip(test, base):
        k = it.shape[1]
        diff = (it.sort(-1).values != ib.sort(-1).values).any(-1)
        top = lb.topk(k + 1, -1).values
        margin = top[:, k - 1] - top[:, k]
        gap = (lt - lb).abs().amax(-1)
        loose = diff & (margin > 2 * gap)
        check(not bool(loose.any()), f"{what}: every routing flip is a near "
              f"tie (k-th minus (k+1)-th logit <= twice the row's logit "
              f"gap); {int(loose.sum())} are not")
        code_t = torch.where(kt, it, it + n_experts).sort(-1).values
        code_b = torch.where(kb, ib, ib + n_experts).sort(-1).values
        disp = ~diff & (code_t != code_b).any(-1)
        flipped = diff if flipped is None else flipped | diff
        displaced = disp if displaced is None else displaced | disp
        layers.append({"flipped": int(diff.sum()), "displaced": int(
            disp.sum()), "dropped_share": 1.0 - kb.float().mean().item(),
            "max_logit_gap": gap.max().item()})
    return flipped, displaced, layers


def held_gap(got, want, held, what: str) -> float:
    """Rows of `got` and `want` ((rows, n) once flattened) that `held`
    keeps, within the LM bar; returns the largest gap over them."""
    import torch
    g = got.float().reshape(held.shape[0], -1)[held]
    w = want.float().reshape(held.shape[0], -1)[held]
    gap = (g - w).abs()
    check(bool(torch.isfinite(g).all()), f"{what}: finite")
    check(bool((gap <= LM_ATOL + LM_RTOL * w.abs()).all()),
          f"{what} within atol {LM_ATOL} rtol {LM_RTOL} on the {len(g)} "
          f"rows held: max {gap.max().item()}")
    return gap.max().item()


def moe_layerwise(cfg, params, tokens, against: str) -> list:
    """An MoE model held layer by layer on shared inputs: each layer takes
    the base path's hidden state through the base block and the block
    under test. `against` 'plain': the kernel block (impl 'cuda') against
    the plain block ('chunked'); 'cache': the cache path's block
    (`_block_decode`, one token at a time against a fresh cache of the
    layer) against the kernel block. A token whose expert choice flips
    there (a near tie, `routing_flips`) takes another expert's output and
    is exempt at that layer, the rest are held to the LM bar, and at
    least 9 tokens in 10 are held. Over a whole forward a flipped token's
    new state reaches the later tokens through attention in later
    layers, and their gaps then grow with every flip before them."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    b, l = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(l, device=x.device)[None].expand(b, l)
    cache = T.init_cache(cfg, b, l, device=x.device)
    base_impl = "chunked" if against == "plain" else "cuda"
    out = []
    for li in range(cfg.n_layers):
        lp = T.layer(params["layers"], li)
        with RoutingProbe() as pt:
            if against == "plain":
                y = T._block_apply(lp, x, cfg, positions, "cuda")
            else:
                kv = T.layer(cache["kv"], li)
                y = torch.cat([T._block_decode(lp, x[:, i:i + 1], cfg, kv,
                                               i)[0] for i in range(l)], 1)
        with RoutingProbe() as pb:
            x = T._block_apply(lp, x, cfg, positions, base_impl)
        test = pt.records
        if against == "cache":      # token-major (L, B, .) -> (B*L, .)
            test = [tuple(torch.stack(a).transpose(0, 1).reshape(b * l, -1)
                          for a in zip(*test))]
        what = f"{cfg.name} layer {li}, {against} against {base_impl}"
        flipped, displaced, stats = routing_flips(test, pb.records,
                                                  cfg.n_experts, what)
        held = ~(flipped | displaced)
        check(held.float().mean().item() >= 0.9,
              f"{what}: at least 9 tokens in 10 held")
        out.append({**stats[0], "held_max_gap": held_gap(y, x, held, what)})
    return out


def family_run(arch: str, layers, prefill_shape, serve_shape, seed: int,
               dev) -> dict:
    """One model of `lm_families`: the counted kernel prefill, its time
    beside the plain prefill's, the kernel forward against the plain
    forward (routing first for MoE), serve_batch with its prompt logits
    against a kernel prefill of the same prompts, and one decode step's
    profile."""
    import dataclasses

    import torch
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    moe = cfg.n_experts > 0
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "reduced": None if layers is None else
           f"n_layers {get_config(arch).n_layers} -> {layers}",
           "params": sum(t.numel() for t in _tensors(params)),
           "weights_gb": sum(t.numel() * t.element_size()
                             for t in _tensors(params)) / 1e9,
           "init_s": time.perf_counter() - t0}
    rng = np.random.default_rng(seed)
    b, l = prefill_shape
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (b, l)), device=dev)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((b, cfg.encoder_frames, cfg.d_model),
                                      generator=gen, device=dev).bfloat16()
    if cfg.frontend == "vision":
        batch["patch_embeds"] = (torch.randn(
            (b, N_PATCHES, cfg.d_model), generator=gen, device=dev)
            * 0.02).bfloat16()
    prefill = make_prefill_step(cfg, impl="cuda")
    plain = make_prefill_step(cfg, impl="chunked")
    prefill(params, batch)                     # cuBLAS and allocator warm-up
    torch.cuda.synchronize()

    # the counted prefill: self-attention a layer, and cross-attention a
    # decoder layer for whisper (its encoder runs 'chunked')
    reset_launches()
    prefill(params, batch)
    torch.cuda.synchronize()
    out["prefill_launches"] = dict(KERNEL_LAUNCHES)
    want = cfg.n_layers * (2 if cfg.family == "audio" else 1)
    check(out["prefill_launches"]["flash_attention"] == want,
          f"{arch}: flash launches {out['prefill_launches']} == {want} per "
          "prefill")
    out["prefill_shape"] = [b, l]
    out["prefill_ms"] = cuda_ms(lambda: prefill(params, batch), runs=5)
    out["plain_prefill_ms"] = cuda_ms(lambda: plain(params, batch), runs=5)
    out["prefill_profile"] = device_profile(
        lambda: prefill(params, batch), kernels=("flash_kernel_bf16",))

    # the kernel forward against the plain forward: for MoE, routing
    # first, then layer by layer on shared inputs (`moe_layerwise`)
    with RoutingProbe() as pk:
        h_cuda = T.forward(cfg, params, batch, impl="cuda")
    with RoutingProbe() as pp:
        h_plain = T.forward(cfg, params, batch, impl="chunked")
    if moe:
        flipped, displaced, per_layer = routing_flips(
            pk.records, pp.records, cfg.n_experts, f"{arch} kernel forward")
        held = ~(flipped | displaced)
        gap = (h_cuda.float() - h_plain.float()).abs().reshape(b * l, -1)
        within = (gap <= LM_ATOL + LM_RTOL * h_plain.float().abs().reshape(
            b * l, -1)).all(-1)
        out["forward_routing"] = {
            "flipped": int(flipped.sum()), "displaced": int(displaced.sum()),
            "held_share": held.float().mean().item(),
            "held_within_bar_share": within[held].float().mean().item(),
            "held_max_gap": gap[held].max().item(), "layers": per_layer}
        kept = torch.stack([k for _, _, k in pk.records]).float()
        out["dropped_share"] = 1.0 - kept.mean().item()
        out["layerwise"] = moe_layerwise(cfg, params, batch["tokens"],
                                         "plain")
    else:
        out["forward_vs_plain_max_gap"] = held_gap(
            h_cuda, h_plain, torch.ones(b * l, dtype=torch.bool, device=dev),
            f"{arch} kernel forward against the plain forward")
    del h_cuda, h_plain, pk, pp

    # serve_batch; its prompt logits against a kernel prefill of the same
    # prompts (for MoE the bar is held layer by layer, `moe_layerwise`)
    sb, sl, sg = serve_shape
    prompts = rng.integers(0, cfg.vocab_size, (sb, sl))
    pc_batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    if cfg.family == "audio":
        pc_batch["frames"] = torch.zeros((sb, cfg.encoder_frames,
                                          cfg.d_model), dtype=torch.bfloat16,
                                         device=dev)
    logits = prefill(params, pc_batch).float()
    reset_launches()
    trace = {}
    tokens = serve_batch(cfg, params, prompts, sg, trace=trace)
    out["serve_launches"] = dict(KERNEL_LAUNCHES)
    out["serve_shape"] = [sb, sl, sg]
    check(tokens.shape == (sb, sg), f"{arch}: serve_batch token shape")
    pl = trace["prompt_logits"].float()
    gap = (logits - pl).abs()
    if moe:
        out["prefill_vs_cache_max_gap"] = gap.max().item()
        out["prefill_vs_cache_within_bar_share"] = (
            gap <= LM_ATOL + LM_RTOL * pl.abs()).float().mean().item()
        out["cache_layerwise"] = moe_layerwise(cfg, params,
                                               pc_batch["tokens"], "cache")
    else:
        out["prefill_vs_cache_max_gap"] = held_gap(
            logits, pl, torch.ones(sb, dtype=torch.bool, device=dev),
            f"{arch} prefill against the cache path after the last prompt "
            "token")
    top2 = logits.topk(2, -1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    decided = margin > 2 * gap.amax(-1).cpu().numpy()
    agree = tokens[:, 0] == logits.argmax(-1).cpu().numpy()
    check(bool(agree[decided].all()), f"{arch}: the first generated token "
          "equals the prefill argmax wherever the margin exceeds twice the "
          "gap")
    out.update(rows_decided=int(decided.sum()), first_token_agrees=
               agree.tolist(), prompt_decode_s=trace["prompt_s"],
               gen_s=trace["gen_s"],
               decode_tokens_per_s=sb * sg / trace["gen_s"])

    # one decode step at the end of the serve length
    cache = T.init_cache(cfg, sb, sl + sg, device=dev)
    if cfg.family == "audio":
        cache["cross"] = T.prime_cross_cache(cfg, params, pc_batch)
    step = make_serve_step(cfg)
    cur = {"tokens": torch.as_tensor(tokens[:, -1:], device=dev),
           "cache_index": sl + sg - 1}
    out["decode_step_profile"] = device_profile(
        lambda: step(params, cache, cur))
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, cache, batch, pc_batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def mixtral_flash(seed: int, dev) -> dict:
    """The flash kernel at mixtral-8x22b's prefill head shape (8 x 48
    query heads over 8 kv heads x 512, D 128, causal; its window of 4,096
    does not bite) beside its plain version and SDPA with enable_gqa."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, hq, hkv, l, d = 8, 48, 8, 512, 128
    q = torch.randn((b, hq, l, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, hkv, l, d), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    rep = hq // hkv
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    got = ops.flash_attention(q, k, v, causal=True, window=4096)
    want = ref.attention_ref(q, kr, vr, causal=True, window=4096)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(err <= FLASH_ATOL["bfloat16"], f"flash at mixtral's shape within "
          f"{FLASH_ATOL['bfloat16']} of its plain version: {err}")
    out = {"shape": [b, hq, hkv, l, l, d], "causal": True, "window": 4096,
           "max_abs_err": err}
    out["ms"] = cuda_ms(lambda: ops.flash_attention(q, k, v, window=4096))
    out["device_ms"] = device_ms(
        lambda: ops.flash_attention(q, k, v, window=4096))
    out["plain_ms"] = cuda_ms(
        lambda: ref.attention_ref(q, kr, vr, window=4096))
    out["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    out["library_device_ms"] = device_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True))
    out["bound_ms"], out["bound_by"] = flash_bound_ms(b, hq, l, l, d, 2,
                                                      hkv=hkv)
    out["bound_peaks"] = BF16_PEAKS
    rates(out, flash_ops(b, hq, l, l, d))
    return out


def lm_families(seed: int, dev) -> dict:
    """The moe, audio and vlm families (FAMILY_RUNS), one model at a
    time, each run's launch counts read from 0 inside; then the flash
    kernel at mixtral's head shape."""
    out = {}
    for i, (arch, layers, pre, srv) in enumerate(FAMILY_RUNS):
        out[arch] = family_run(arch, layers, pre, srv, seed + i, dev)
        emit(f"lm_family_{arch}", **out[arch])
    check(any(r["rows_decided"] for r in out.values()),
          "some row's margin exceeds twice its logit gap")
    out["flash_mixtral"] = mixtral_flash(seed, dev)
    return out


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


def micro_batches(batch):
    """The arrival batch in the main path's micro-batches of BATCH."""
    for lo in range(0, len(batch), BATCH):
        yield type(batch)(*(getattr(batch, f)[lo:lo + BATCH]
                            for f in type(batch).__dataclass_fields__))


def featurizer_determinism(run, hist, parts, dev) -> dict:
    """The history table built twice on the card is bit-equal (to itself,
    to the main path's, and to the CPU's), and a second pipeline serving
    the same arrivals gives the same servers and conservative count."""
    import torch
    from repro_torch.serve import ServePipeline, table_from_history
    pipe = run["pipe"]
    cap = pipe.table.capacity
    a = table_from_history(hist, run["labels"], cap, device=dev)
    b = table_from_history(hist, run["labels"], cap, device=dev)
    cpu = table_from_history(hist, run["labels"], cap, device="cpu")
    for f, x, y, z, w in zip(a._fields, a, b, pipe.table, cpu):
        check(torch.equal(x, y) and torch.equal(x, z),
              f"history table column {f} bit-equal across card builds")
        check(torch.equal(x.cpu(), w),
              f"history table column {f} bit-equal to the CPU's")
    pipe2 = ServePipeline.from_history(
        run["svc"], hist, run["labels"], n_servers=N_SERVERS,
        cores_per_server=CORES, blades_per_chassis=BLADES,
        config=run["config"], device=dev)
    parts2 = [pipe2.serve(chunk) for chunk in micro_batches(run["batch"])]
    conservative = [int(sum(p.n_conservative for p in ps))
                    for ps in (parts, parts2)]
    check(conservative[0] == conservative[1],
          f"two serves give one conservative count: {conservative}")
    for f in ("server", "conservative", "p95_eff"):
        check(np.array_equal(np.concatenate([getattr(p, f) for p in parts]),
                             np.concatenate([getattr(p, f)
                                             for p in parts2])),
              f"two serves give identical {f}")
    return {"table_rows": cap, "tables_bit_equal": True,
            "cpu_table_bit_equal": True, "conservative": conservative,
            "servers_equal": True}


def fleet_gaps(ref, got) -> dict:
    """The largest gaps of a fleet run against the numpy oracle's, in the
    quantities the reference's numpy-vs-jax bars hold."""
    return {
        "power_w": float(np.abs(ref.power_w - got.power_w).max()),
        "min_nuf_freq": float(np.abs(ref.min_nuf_freq
                                     - got.min_nuf_freq).max()),
        "rapl_frac": float(np.abs(ref.rapl_engaged_frac
                                  - got.rapl_engaged_frac).max()),
        "uf_p95_rel": float(np.abs(got.uf_p95_latency / ref.uf_p95_latency
                                   - 1).max()),
        "nuf_slowdown_rel": float(np.abs(got.nuf_slowdown / ref.nuf_slowdown
                                         - 1).max())}


def check_fleet_bars(gaps: dict, what: str) -> None:
    for k, lim in FLEET_BARS.items():
        check(gaps[k] <= lim, f"{what}: {k} gap {gaps[k]} within {lim}")


def fleet_parity(dev) -> dict:
    """Fig 4-5 (one server: 230 W per-VM, 230 W RAPL, 210 W per-VM) and
    Fig 6 (the balanced and imbalanced chassis at 2,450 W) on the card
    against the numpy oracle."""
    from repro_torch.sim import chassis_sim, fleet
    cases = [("fig45", [chassis_sim.paper_single_server_spec()], b, m, 3)
             for b, m in FIG45] + [
        (f"fig6_{name}", chassis_sim.paper_chassis_specs(bal), 2450.0,
         "per_vm", 4) for name, bal in (("balanced", True),
                                        ("imbalanced", False))]
    out = []
    for name, specs, budget, mode, seed in cases:
        ref = fleet.run_fleet(specs, budget, mode, FLEET_DUR_S, seed,
                              backend="numpy")
        got = fleet.run_fleet(specs, budget, mode, FLEET_DUR_S, seed,
                              device=dev)
        gaps = fleet_gaps(ref, got)
        check_fleet_bars(gaps, f"fleet_parity {name} {budget} W {mode}")
        out.append({"case": name, "budget_w": budget, "mode": mode,
                    "rapl_engaged_frac": float(got.rapl_engaged_frac[0]),
                    "uf_p95_latency": float(got.uf_p95_latency[0]),
                    "nuf_slowdown": float(got.nuf_slowdown[0]),
                    "max_gaps": gaps})
    return {"duration_s": FLEET_DUR_S, "cases": out}


def fleet_scale(dev) -> dict:
    """The balanced paper chassis at 2,450 W, per-chassis seeds, 150 steps,
    at 1, 64 and 1,024 chassis: chassis-steps/s of `run_fleet` with the
    traces given (layout upload, the step loop, the copy back and the
    host aggregation), launches per step and device busy share from the
    profiler, and 8 of the 1,024 chassis against the numpy oracle."""
    import torch
    from repro_torch.sim import chassis_sim, fleet
    specs = chassis_sim.paper_chassis_specs(True)
    layout = fleet.build_layout(specs)
    fleet.run_fleet(specs, 2450.0, "per_vm", 2.0, 0, device=dev)  # warm-up
    out = []
    for n in FLEET_SCALE:
        t0 = time.perf_counter()
        traces = np.stack([fleet.build_uf_traces(layout, FLEET_STEPS, s)
                           for s in range(n)])
        trace_s = time.perf_counter() - t0

        def run():
            return fleet.run_fleet(specs, np.full(n, 2450.0), "per_vm",
                                   FLEET_STEPS * 0.2, layout=layout,
                                   traces=traces, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        run_s = time.perf_counter() - t0
        prof = device_profile(run)
        row = {"chassis": n, "steps": FLEET_STEPS, "trace_gen_s": trace_s,
               "run_s": run_s,
               "chassis_steps_per_s": n * FLEET_STEPS / run_s,
               "launches_per_step": prof["launches"] / FLEET_STEPS,
               "device_busy_ms": prof["device_busy_ms"],
               "device_idle_share": prof["device_idle_share"],
               "profiled_wall_ms": prof["wall_ms"],
               "top_device_ms": prof["top_device_ms"],
               "alert_frac_mean": float(res.alert_frac.mean()),
               "rapl_engaged_frac_mean": float(res.rapl_engaged_frac.mean())}
        if n >= 8:
            idx = np.linspace(0, n - 1, 8).astype(np.int64)
            ref = fleet.run_fleet(specs, np.full(8, 2450.0), "per_vm",
                                  FLEET_STEPS * 0.2, layout=layout,
                                  traces=traces[idx], backend="numpy")
            sub = fleet.FleetResult(*(getattr(res, f)[idx] for f in (
                "power_w", "min_nuf_freq", "uf_latency", "alert_frac",
                "rapl_engaged_frac", "uf_p95_latency", "nuf_slowdown")))
            gaps = fleet_gaps(ref, sub)
            check_fleet_bars(gaps, f"fleet_scale {n} chassis, 8 checked")
            row["parity_chassis"] = idx.tolist()
            row["max_gaps"] = gaps
        out.append(row)
    return {"budget_w": 2450.0, "runs": out}


def table4_sweep(dev) -> dict:
    """`sweep_scenarios` + `frontier` over a (budget x load-scale x NUF
    floor) grid for the Fig 4-5 server on the card, against the numpy
    oracle's sweep: the same frontier, the metrics within the bars."""
    from repro_torch.sim import chassis_sim, fleet
    specs = [chassis_sim.paper_single_server_spec()]
    kw = dict(load_scales=T4_LOADS, fmin_nuf=T4_FLOORS,
              duration_s=FLEET_DUR_S, seed=3)
    t0 = time.perf_counter()
    got = fleet.sweep_scenarios(specs, T4_BUDGETS, device=dev, **kw)
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = fleet.sweep_scenarios(specs, T4_BUDGETS, backend="numpy", **kw)
    numpy_s = time.perf_counter() - t0
    gaps = {"power_max_w": float(np.abs(got["power_max_w"]
                                        - ref["power_max_w"]).max()),
            "rapl_frac": float(np.abs(got["rapl_engaged_frac"]
                                      - ref["rapl_engaged_frac"]).max())}
    for name in ("uf_p95_latency", "nuf_slowdown", "uf_latency_ratio"):
        gaps[name + "_rel"] = float(np.abs(got[name] / ref[name] - 1).max())
    check(gaps["power_max_w"] <= FLEET_BARS["power_w"]
          and gaps["rapl_frac"] <= FLEET_BARS["rapl_frac"]
          and max(gaps[k] for k in gaps if k.endswith("_rel")) <= 1e-3,
          f"table4 sweep within the bars of the numpy oracle: {gaps}")
    fr_got = fleet.frontier(got, 310.0)
    fr_ref = fleet.frontier(ref, 310.0)
    for k in fr_ref:
        check(np.array_equal(fr_got[k], fr_ref[k]),
              f"table4 frontier {k} equals the numpy oracle's")
    return {"grid": [len(T4_BUDGETS) + 1, len(T4_LOADS), len(T4_FLOORS)],
            "steps": int(FLEET_DUR_S / 0.2), "sweep_s": sweep_s,
            "numpy_s": numpy_s, "max_gaps": gaps,
            "frontier_budget_w": fr_got["budget_w"].tolist(),
            "frontier_oversubscription": fr_got["oversubscription"].tolist()}


def scheduler_sim(dev) -> dict:
    """`simulate` with alpha 0.8 and the `ml` channel over SIM_DAYS days:
    the event backend on the host and the serve backend on the card give
    one trace; the admission-budget run on the card equals the same run
    on the CPU; the power evaluation on the card meets the bars against
    the numpy oracle."""
    import torch
    from repro_torch.core.placement import SchedulerPolicy
    from repro_torch.core.resources import ResourceVector
    from repro_torch.sim import scheduler_sim as S
    pol, ch = SchedulerPolicy(alpha=0.8), S.PredictionChannel("ml")
    out = {"days": SIM_DAYS}
    traces = {}
    for name, backend in (("event", "event"), ("serve", "serve")):
        tr = []
        t0 = time.perf_counter()
        m = S.simulate(pol, ch, S.SimSpec(days=SIM_DAYS, seed=0, serve=S.
                                          ServeBackendSpec(backend=backend)),
                       trace=tr, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        traces[name] = tr
        out[name] = {"seconds": wall, "arrivals_per_s": m.placements / wall,
                     "placements": m.placements, "failures": m.failures,
                     "failure_rate": m.failure_rate,
                     "chassis_score_std": m.chassis_score_std,
                     "server_score_std": m.server_score_std,
                     "empty_server_ratio": m.empty_server_ratio}
    check(traces["serve"] == traces["event"],
          "serve backend on the card places as the event backend")
    out["traces_equal"] = True
    secs = {}
    t0 = time.perf_counter()
    short = S.SimSpec(days=SIM_PROFILE_DAYS, seed=0,
                      serve=S.ServeBackendSpec(backend="serve"))
    runs = []
    prof = device_profile(
        lambda: runs.append(S.simulate(pol, ch, short, device=dev)))
    n_short = runs[-1].placements
    secs["serve_profile"] = time.perf_counter() - t0
    out["serve_profile"] = {
        "days": SIM_PROFILE_DAYS, "placements": n_short,
        "launches_per_arrival": prof["launches"] / n_short,
        "device_busy_ms": prof["device_busy_ms"],
        "device_idle_share": prof["device_idle_share"],
        "wall_ms": prof["wall_ms"]}
    budget = S.SimSpec(days=0.5, seed=0, serve=S.ServeBackendSpec(
        backend="serve", admission_budget=ResourceVector(
            watts=TIGHT_BUDGET_W)))
    tr_card, tr_cpu = [], []
    t0 = time.perf_counter()
    m = S.simulate(pol, ch, budget, trace=tr_card, device=dev)
    S.simulate(pol, ch, budget, trace=tr_cpu, device="cpu")
    secs["admission_budget_card_and_cpu"] = time.perf_counter() - t0
    check(tr_card == tr_cpu, "admission-budget run: card trace == CPU trace")
    check(m.failure_rate > 0.2, f"the tight budget rejects: {m.failure_rate}")
    out["admission_budget"] = {"watts": TIGHT_BUDGET_W,
                               "placements": m.placements,
                               "failure_rate": m.failure_rate,
                               "power_rejects": tr_card.count(-2),
                               "cpu_trace_equal": True}
    power = {}
    for backend in ("torch", "numpy"):
        t0 = time.perf_counter()
        spec = S.SimSpec(days=SIM_DAYS, seed=0, prefill_core_ratio=0.5,
                         power=S.PowerEvalSpec(budget_w=2000.0, chassis=8,
                                               duration_s=60.0,
                                               backend=backend))
        power[backend] = S.simulate(pol, ch, spec, device=dev).power
        secs[f"power_eval_{backend}"] = time.perf_counter() - t0
    pt, pn = power["torch"], power["numpy"]
    check(np.array_equal(pt.chassis_ids, pn.chassis_ids),
          "power evaluation picks the same chassis")
    gaps = {"power_max_w": float(np.abs(pt.power_max_w
                                        - pn.power_max_w).max()),
            "rapl_frac": float(np.abs(pt.rapl_engaged_frac
                                      - pn.rapl_engaged_frac).max()),
            "alert_frac": float(np.abs(pt.alert_frac - pn.alert_frac).max()),
            "uf_p95_rel": float(np.abs(pt.uf_p95_latency / pn.uf_p95_latency
                                       - 1).max()),
            "nuf_slowdown_rel": float(np.abs(pt.nuf_slowdown
                                             / pn.nuf_slowdown - 1).max())}
    check(gaps["power_max_w"] <= FLEET_BARS["power_w"]
          and gaps["rapl_frac"] <= FLEET_BARS["rapl_frac"]
          and gaps["alert_frac"] <= FLEET_BARS["rapl_frac"]
          and gaps["uf_p95_rel"] <= 1e-3 and gaps["nuf_slowdown_rel"] <= 1e-3,
          f"power evaluation on the card within the bars: {gaps}")
    out["power_eval"] = {"budget_w": 2000.0, "chassis": pt.chassis_ids.tolist(),
                         "alert_frac": pt.alert_frac.tolist(),
                         "rapl_engaged_frac": pt.rapl_engaged_frac.tolist(),
                         "max_gaps": gaps}
    out["seconds"] = secs
    return out


#: Streamed serving cell: the serving cell's arrivals pushed through the
#: per-host ingest with a departure stream (every DEPART_EVERY-th
#: admitted VM of micro-batch k-2 leaves after micro-batch k), a cap
#: sweep of every chassis after micro-batch 0 and each SWEEP_EVERY
#: micro-batches on at the paper's 2x budget (12 x 310 W provisioned,
#: budgeted at half), and one migration cycle after micro-batch
#: MIGRATE_AFTER, the second sweep, while the empty chassis still have
#: headroom for the moved VMs. The cluster starts
#: warm: every WARM_EVERY-th chassis holds WARM_OCCUPANCY of its cores
#: in mostly critical VMs (a hot chassis whose cut reaches the critical
#: level, so the dwell trigger fires), the others start empty (the
#: migration's destinations).
STREAM_HOSTS = (1, 4)
DEPART_EVERY, SWEEP_EVERY, SWEEP_UTIL = 4, 4, 0.85
EMERGENCY_BUDGET_W = 12 * 310.0 / 2.0
STREAM_DWELL_S, MIGRATE_AFTER = 600.0, 4
#: Micro-batches of the streamed cell's profiled run (its idle share).
STREAM_PROFILE_BATCHES = 2
WARM_EVERY, WARM_OCCUPANCY, WARM_UF = 3, 0.7, 0.7
#: The reference benchmark's 2x emergency sim (benchmarks/serve_emergency.py)
#: and its record (BENCH_serve_emergency.json, `throttled_2x`).
EMERGENCY_SIM = dict(days=0.55, seed=0, deployments_per_hour=16.0,
                     prefill_core_ratio=0.75)
EMERGENCY_SIM_DWELL_S = 1800.0


def _rows(batch, rows):
    return type(batch)(*(getattr(batch, f)[rows]
                         for f in type(batch).__dataclass_fields__))


def warm_cluster(seed: int):
    """The streamed cell's warm start: a host `ClusterState` and its VMs
    as (server, cores, p95, is_uf, GB) arrays, seeded; every VM holds
    GB_PER_CORE GB a core, so the NUF ones give the ballooning rung its
    headroom."""
    from repro_torch.core.placement import ClusterState
    from repro_torch.sim import GB_PER_CORE
    rng = np.random.default_rng(seed)
    st = ClusterState(n_servers=N_SERVERS, cores_per_server=CORES,
                      chassis_of_server=np.arange(N_SERVERS) // BLADES,
                      n_chassis=N_SERVERS // BLADES)
    vms = []
    for c in range(0, N_SERVERS // BLADES, WARM_EVERY):
        filled, i = 0.0, 0
        while filled < WARM_OCCUPANCY * BLADES * CORES:
            srv = c * BLADES + i % BLADES
            cores = int(rng.choice([2, 4, 8]))
            if st.free_cores[srv] >= cores:
                p95 = float(rng.uniform(0.5, 0.9))
                uf = bool(rng.random() < WARM_UF)
                st.place(srv, cores, p95, uf)
                vms.append((srv, cores, p95, uf))
                filled += cores
            i += 1
    cols = list(zip(*vms))
    cores = np.array(cols[1], np.float64)
    return st, (np.array(cols[0], np.int64), cores,
                np.array(cols[2], np.float64), np.array(cols[3], bool),
                cores * GB_PER_CORE)


def _stream_pipeline(run, hist, labels, budget_w, warm_state, warm, hosts,
                     device, shards=None, mesh=None, **planes):
    """A streamed-cell pipeline on `device` over the warm cluster, its GB
    ledger (total and NUF slice) seeded from the warm VMs, with the
    `PlaneBundle` fields given in `planes`; a `ShardedServePipeline` of
    `shards` shards when given, one shard a device of `mesh` when
    given."""
    from repro_torch.serve import (PlaneBundle, ResourceVector, ServeConfig,
                                   ServePipeline, ShardedServeConfig,
                                   ShardedServePipeline, device_state,
                                   table_from_history)
    chassis = warm[0] // BLADES
    n_chassis = N_SERVERS // BLADES
    state = device_state(
        warm_state, device=device,
        mem_gb=np.bincount(chassis, weights=warm[4], minlength=n_chassis),
        mem_nuf=np.bincount(chassis, weights=warm[4] * ~warm[3],
                            minlength=n_chassis))
    table = table_from_history(
        hist, labels, max(v.subscription for v in hist.vms) + 1024, device)
    cls, cfg, extra = (ServePipeline, ServeConfig, {}) if shards is None \
        else (ShardedServePipeline, ShardedServeConfig, {"n_shards": shards})
    return cls(run["svc"], table, state, CORES, blades_per_chassis=BLADES,
               config=cfg(batch_size=BATCH, n_ingest_hosts=hosts,
                          planes=PlaneBundle(
                              chassis_budget=ResourceVector(watts=budget_w),
                              **planes), **extra),
               **({} if mesh is None else {"mesh": mesh}))


def streamed(pipe, batch, hosts: int, plane: bool, warm, samples=None,
             utils=None, sweep_every: int = SWEEP_EVERY):
    """Push `batch` through `submit_to` in micro-batch chunks dealt row by
    row over `hosts` (unit-clock stamps from `arrival_stamps`), with the
    departure stream (each VM's GB with it) and, with `plane`, a cap
    sweep after every `sweep_every`-th micro-batch (stamps between
    arrival ticks) and one migration cycle (flush -> due chassis ->
    `plan_migrations` over the live VMs, `warm` ones included -> paired
    events through `depart_to` -> `reset_dwell`). Sweep powers are
    `samples` when given, else `sampled_power` at SWEEP_UTIL (or the next
    value of `utils`) on the pipeline's live aggregates (recorded in the
    result). With the ballooning rung, each sweep's inflations (chassis
    whose balloon grew) are counted, read right after the sweep, which
    with one host is when it applies. Returns the decisions and what the
    checks read; the wall covers the whole stream, which ends in host
    fetches."""
    import dataclasses
    import torch
    from repro_torch.serve import emergency, mitigation
    from repro_torch.serve.ballooning import TOL_W
    from repro_torch.sim.telemetry import arrival_stamps
    n, nw = len(batch), len(warm[0])
    stamps = arrival_stamps(n)
    # the VM registry: warm VMs first, then the arrivals in stream order
    server_of = np.concatenate([warm[0], np.full(n, -1, np.int64)])
    cores_of = np.concatenate([warm[1], batch.cores.astype(np.float64)])
    p95_of = np.concatenate([warm[2], np.zeros(n)])
    uf_of = np.concatenate([warm[3], np.zeros(n, bool)])
    mem_of = np.concatenate([warm[4], batch.memory_gb.astype(np.float64)])
    departed = np.zeros(nw + n, bool)
    served, swept, cycle, ratios = [], [], None, []
    balloon_events, balloon_peak_gb, need = 0, 0.0, []
    rung = pipe.config.planes.ballooning is not None
    chassis = np.arange(pipe.n_chassis)

    def take(out):
        for r in ([] if out is None else [out] if hasattr(out, "server")
                  else out):
            for lo in range(0, len(r.server), BATCH):
                part = type(r)(*(getattr(r, f.name)[lo:lo + BATCH]
                                 for f in dataclasses.fields(r)))
                rows = nw + len(served) * BATCH + np.arange(BATCH)
                server_of[rows] = part.server
                p95_of[rows] = part.p95_eff
                uf_of[rows] = part.workload_type == 1
                served.append(part)

    t0 = time.perf_counter()
    for k in range(n // BATCH):
        idx = np.arange(k * BATCH, (k + 1) * BATCH)
        for h in range(hosts):
            rows = idx[idx % hosts == h]
            take(pipe.submit_to(h, _rows(batch, rows), t=stamps[rows]))
        t_end = stamps[idx[-1]]
        if k >= 2:
            rows = nw + (k - 2) * BATCH + np.flatnonzero(
                served[k - 2].server >= 0)[::DEPART_EVERY]
            departed[rows] = True
            take(pipe.depart_to(
                k % hosts, server_of[rows], cores_of[rows], p95_of[rows],
                uf_of[rows], mem_gb=mem_of[rows],
                t=t_end + 0.25 + 1e-6 * np.arange(len(rows))))
        if plane and k % sweep_every == 0:
            if samples is None:
                st = pipe.state
                rho = emergency.chassis_rho_levels(
                    st.gamma_nuf, st.gamma_uf, st.chassis_servers)
                power = emergency.sampled_power(
                    pipe.emergency_cfg, rho,
                    SWEEP_UTIL if utils is None else utils[len(swept)],
                    torch.zeros(rho.shape, dtype=torch.int32,
                                device=rho.device),
                    torch.zeros(rho.shape[0], dtype=torch.bool,
                                device=rho.device)).cpu().numpy()
            else:
                power = samples[len(swept)]
            swept.append(power)
            before = pipe.balloon_state.ballooned_gb.clone() if rung \
                else None
            if rung:
                need.append(_balloon_need(pipe, power))
            take(pipe.cap_to((k + 1) % hosts, chassis, power,
                             t=t_end + 0.5 + (chassis + 1) * 1e-7))
            if rung:
                after = pipe.balloon_state.ballooned_gb
                balloon_events += int(((after - before) > TOL_W).sum())
                balloon_peak_gb = max(balloon_peak_gb, pipe.ballooned_gb())
            ratios.append(pipe.adaptive_ratio)
        if plane and k == MIGRATE_AFTER:
            take(pipe.flush())
            due = pipe.mitigation_due_chassis()
            live = np.flatnonzero((server_of >= 0) & ~departed)
            st = pipe.state
            plan = mitigation.plan_migrations(
                pipe.emergency_cfg, mitigation.LiveVMs(
                    server_of[live].astype(np.int32), cores_of[live],
                    p95_of[live], uf_of[live], token=live,
                    mem_gb=mem_of[live]),
                st.chassis_of.cpu().numpy(),
                st.free_cores.double().cpu().numpy(),
                emergency.chassis_rho_levels_np(
                    st.gamma_nuf.double().cpu().numpy(),
                    st.gamma_uf.double().cpu().numpy(),
                    st.chassis_servers.cpu().numpy()),
                SWEEP_UTIL, np.isin(chassis, due))
            dep, arr = plan.as_events()
            t_dep, t_arr = plan.paired_stamps(t_end + 0.75)
            for i in range(len(plan)):
                for ev, t in ((dep, t_dep), (arr, t_arr)):
                    take(pipe.depart_to(
                        i % hosts, ev.server[i:i + 1], ev.cores[i:i + 1],
                        ev.p95_eff[i:i + 1], ev.is_uf[i:i + 1],
                        mem_gb=ev.mem_gb[i:i + 1], t=t[i:i + 1]))
            server_of[plan.token] = plan.dst_server
            pipe.reset_dwell(due)
            cycle = {"due_chassis": due.tolist(), "moves": len(plan),
                     "src": plan.src_server.tolist(),
                     "dst": plan.dst_server.tolist()}
    take(pipe.flush())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"servers": np.concatenate([r.server for r in served]),
            "conservative": np.concatenate([r.conservative
                                            for r in served]),
            "wall": wall, "arrivals_per_s": n / wall,
            "micro_batches": len(served), "departures": int(departed.sum()),
            "sweeps": len(swept), "samples": swept, "cycle": cycle,
            "alarms": pipe.alarms if plane else 0,
            "throttled_by_level": pipe.throttled_by_level(),
            "ratios": ratios, "balloon_events": balloon_events,
            "ballooned_peak_gb": balloon_peak_gb,
            "ballooned_gb": pipe.ballooned_gb(), "balloon_need": need}


def _balloon_need(pipe, power) -> dict:
    """What the ballooning rung is asked for at a sweep, read on the host
    before the sweep applies: the largest per-chassis demand (the DRAM
    watts that keep the cut inside the NUF floor, from the numpy oracle
    on the credited sample), the watts the chassis' NUF headroom could
    absorb there, and how many chassis ask for more than their
    headroom."""
    from repro_torch.serve import ballooning, emergency
    st, bcfg = pipe.state, pipe.config.planes.ballooning
    ballooned = pipe.balloon_state.ballooned_gb.double().cpu().numpy() \
        .reshape(-1)
    rho = emergency.chassis_rho_levels_np(
        st.gamma_nuf.double().cpu().numpy(),
        st.gamma_uf.double().cpu().numpy(), st.chassis_servers.cpu().numpy())
    _, demand = ballooning.balloon_demand_w_np(
        pipe.emergency_cfg, rho, power - bcfg.w_per_gb * ballooned)
    headroom_w = bcfg.w_per_gb * np.maximum(
        bcfg.reclaim_frac * st.mem_nuf.double().cpu().numpy() - ballooned, 0)
    i = int(np.argmax(demand))
    return {"demand_w_max": float(demand[i]),
            "headroom_w_there": float(headroom_w[i]),
            "chassis_short": int((demand > headroom_w).sum())}


def streamed_serve(run, hist, arrivals, budget_w: float, seed: int,
                   dev) -> dict:
    """The streamed serving loop with the power-emergency plane on the
    card (see `streamed`), its launch counts read from 0 (history
    labeling plus the 1-host run); then the same stream with the plane
    off, at 4 hosts, on the CPU, and once more on the card, and the
    launches and device idle share of its pieces."""
    import torch
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.core import criticality
    from repro_torch.serve import EmergencyConfig
    from repro_torch.sim.telemetry import arrival_batch
    batch = arrival_batch(arrivals)
    ecfg = EmergencyConfig.from_model(EMERGENCY_BUDGET_W,
                                      dwell_s=STREAM_DWELL_S)
    warm_state, warm = warm_cluster(seed)

    def pipeline(hosts, plane, labels, device=dev):
        return _stream_pipeline(run, hist, labels, budget_w, warm_state,
                                warm, hosts, device,
                                emergency=ecfg if plane else None)

    reset_launches()
    labels = criticality.classify(hist.series, device=dev).cpu().numpy()
    on1 = streamed(pipeline(1, True, labels), batch, 1, True, warm)
    launches = dict(KERNEL_LAUNCHES)
    check(launches["forest"] == on1["micro_batches"] == len(batch) // BATCH,
          f"streamed path: a forest launch per micro-batch: {launches}")
    check(launches["template"] >= 1, "streamed path labels on the card")
    check(on1["alarms"] > 0, "the cap sweeps raise alarms (else the "
          "measurement is dead)")
    check(on1["cycle"] is not None and on1["cycle"]["due_chassis"]
          and on1["cycle"]["moves"] > 0,
          f"the migration cycle finds due chassis and moves VMs: "
          f"{on1['cycle']}")
    runs = {"on_1": on1, "off_1": streamed(pipeline(1, False, labels),
                                           batch, 1, False, warm)}
    pipes = {}
    for hosts in STREAM_HOSTS[1:]:
        pipes[hosts] = pipeline(hosts, True, labels)
        runs[f"on_{hosts}"] = streamed(pipes[hosts], batch, hosts, True,
                                       warm, on1["samples"])
        runs[f"off_{hosts}"] = streamed(pipeline(hosts, False, labels),
                                        batch, hosts, False, warm)
    pipes[1] = pipeline(1, True, labels)
    again = streamed(pipes[1], batch, 1, True, warm)
    cpu_pipe = pipeline(1, True, labels, device="cpu")
    cpu = streamed(cpu_pipe, batch, 1, True, warm, on1["samples"])

    def same(a, b, what):
        for f in ("servers", "conservative", "throttled_by_level"):
            check(np.array_equal(a[f], b[f]), f"{what}: equal {f}")
        check(a["alarms"] == b["alarms"] and a["cycle"] == b["cycle"],
              f"{what}: equal alarms and migration cycle")
    for hosts in STREAM_HOSTS[1:]:
        same(runs[f"on_{hosts}"], on1, f"{hosts} hosts against 1")
        for f in ("free_cores", "gamma_uf", "gamma_nuf", "res_peak"):
            check(torch.equal(getattr(pipes[hosts].state, f),
                              getattr(pipes[1].state, f)),
                  f"{hosts} hosts: final {f} bit-equal to 1 host's")
        for f, a, b in zip(pipes[1].emergency._fields, pipes[1].emergency,
                           pipes[hosts].emergency):
            check(torch.equal(a, b), f"{hosts} hosts: emergency {f} equal")
    same(again, on1, "the card's run repeated")
    check(all(np.array_equal(a, b) for a, b in zip(again["samples"],
                                                   on1["samples"])),
          "the repeated run samples the same live aggregates, bit for bit")
    same(cpu, on1, "the CPU against the card")
    state_gap = {f: float((getattr(pipes[1].state, f).cpu()
                           - getattr(cpu_pipe.state, f)).abs().max())
                 for f in ("free_cores", "gamma_uf", "gamma_nuf",
                           "res_peak")}
    for f, v in state_gap.items():
        check(v <= 1e-6 * max(1.0, float(getattr(cpu_pipe.state, f).abs()
                                         .max())),
              f"CPU final {f} within float32 rounding of the card's: {v}")

    # the launches of one micro-batch, of one fused with a cap window, of
    # one standalone cap window; the device idle share of a short stream
    pipe = pipeline(1, True, labels)
    chunks = [_rows(batch, np.arange(i * BATCH, (i + 1) * BATCH))
              for i in range(3)]
    power = on1["samples"][-1]
    chassis = np.arange(pipe.n_chassis)

    def launches_of(fn):
        return device_profile(lambda: None, fn)["launches"]
    stamps = np.arange(1.0, 3 * BATCH + 1.0).reshape(3, BATCH)
    per_batch = launches_of(lambda: pipe.submit_to(0, chunks[0],
                                                   t=stamps[0]))
    per_fused = launches_of(lambda: (
        pipe.cap_to(0, chassis, power, t=stamps[0, -1] + 0.5
                    + (chassis + 1) * 1e-7),
        pipe.submit_to(0, chunks[1], t=stamps[1])))
    per_window = launches_of(lambda: (
        pipe.cap_to(0, chassis, power, t=stamps[1, -1] + 0.5
                    + (chassis + 1) * 1e-7), pipe.alarms))
    n = STREAM_PROFILE_BATCHES * BATCH
    seg = [_rows(batch, np.arange(i * n, (i + 1) * n)) for i in range(2)]
    prof = device_profile(
        lambda: streamed(pipeline(1, True, labels), seg[0], 1, True, warm),
        lambda: streamed(pipeline(1, True, labels), seg[1], 1, True, warm))
    rate = {k: v["arrivals_per_s"] for k, v in runs.items()}
    rate["on_1_again"] = again["arrivals_per_s"]
    return {
        "labels": labels,
        "arrivals": len(batch), "micro_batches": on1["micro_batches"],
        "warm_vms": len(warm[0]), "warm_chassis": len(range(
            0, N_SERVERS // BLADES, WARM_EVERY)),
        "budget_w": EMERGENCY_BUDGET_W, "dwell_s": STREAM_DWELL_S,
        "departures": on1["departures"], "sweeps": on1["sweeps"],
        "alarms": on1["alarms"],
        "throttled_by_level": on1["throttled_by_level"].tolist(),
        "admitted": int((on1["servers"] >= 0).sum()),
        "power_rejected": int((on1["servers"] == -2).sum()),
        "migration_cycle": on1["cycle"], "launches": launches,
        "arrivals_per_s": rate,
        "plane_overhead_share": {
            h: 1.0 - rate[f"on_{h}"] / rate[f"off_{h}"]
            for h in STREAM_HOSTS},
        "hosts_equal": True, "cpu_equal": True, "repeat_bit_equal": True,
        "cpu_state_max_gap": state_gap,
        "launches_per_micro_batch": per_batch,
        "launches_per_fused_micro_batch": per_fused,
        "launches_per_cap_window": per_window,
        "launches_per_cap_window_fused": per_fused - per_batch,
        "profile": {"arrivals": n, **{k: prof[k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share", "launches")}}}


def _emergency_sim(backend: str, blind: bool, dev):
    """`simulate` with the emergency plane at the reference benchmark's
    2x settings on `backend` (`dev` unused by the event backend): its
    metrics, trace and seconds."""
    from repro_torch.core.placement import SchedulerPolicy
    from repro_torch.serve import EmergencyConfig
    from repro_torch.sim import scheduler_sim as S
    tr = []
    t0 = time.perf_counter()
    m = S.simulate(SchedulerPolicy(alpha=0.8), S.PredictionChannel("ml"),
                   S.SimSpec(emergency=EmergencyConfig.from_model(
                       EMERGENCY_BUDGET_W, dwell_s=EMERGENCY_SIM_DWELL_S,
                       criticality_blind=blind),
                       serve=S.ServeBackendSpec(backend=backend),
                       **EMERGENCY_SIM), trace=tr, device=dev)
    return m, tr, time.perf_counter() - t0


def sim_emergency(dev) -> dict:
    """`simulate` with the emergency plane at the reference benchmark's
    2x settings, aware and blind, on the event backend on the host (each
    in a process of its own, alongside the card's run), and the aware run
    again on the serve backend on the card (its torch twin held bit-equal
    to the numpy oracle on every scan): the serve trace and every
    `SimMetrics` field equal the event backend's, aware gives fewer
    critical throttled-seconds than blind, and the numbers stand beside
    the reference's record."""
    import dataclasses
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    metrics, traces, secs = {}, {}, {}
    # the event backend runs on the host alone: its two runs go in
    # processes of their own while the card's run goes here
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        host = {name: pool.submit(_emergency_sim, "event", blind, None)
                for name, blind in (("aware", False), ("blind", True))}
        (metrics["aware_serve"], traces["aware_serve"],
         secs["aware_serve"]) = _emergency_sim("serve", False, dev)
        for name, fut in host.items():
            metrics[name], traces[name], secs[name] = fut.result()
    check(traces["aware_serve"] == traces["aware"],
          "emergency sim: serve trace on the card == event trace")
    a, s = metrics["aware"], metrics["aware_serve"]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(s, f.name)
        check(np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y,
              f"emergency sim: serve SimMetrics.{f.name} == event's")
    check(metrics["aware"].alarms > 0, "emergency sim raises alarms")
    check(metrics["aware"].uf_throttled_s < metrics["blind"].uf_throttled_s,
          "criticality-aware apportionment throttles critical VMs less "
          "than blind")
    bench = Path(__file__).resolve().parent / "BENCH_serve_emergency.json"
    record = json.loads(bench.read_text())["throttled_2x"]
    out = {**EMERGENCY_SIM, "budget_w": EMERGENCY_BUDGET_W,
           "dwell_s": EMERGENCY_SIM_DWELL_S, "seconds": secs,
           "placements": a.placements, "traces_equal": True,
           "metrics_equal": True,
           "serve_arrivals_per_s": a.placements / secs["aware_serve"]}
    for name in ("aware", "blind"):
        m = metrics[name]
        mine = {"uf_throttled_s": m.uf_throttled_s,
                "nuf_throttled_s": m.nuf_throttled_s, "alarms": m.alarms,
                "migrations": m.migrations}
        out[name] = {"port": mine, "reference_record": record[name],
                     "equal_to_record": mine == record[name]}
    return out


#: The streamed cell with the ballooning rung and the adaptive controller:
#: a sweep after every micro-batch at the next PLANES_UTILS value (calm and
#: rising, so the controller ratchets; hot, so it backs off and the hot
#: chassis' cuts pass the NUF floor and the rung fires; calm again), with
#: the controller of the reference's adaptive benchmark
#: (`benchmarks/serve_adaptive.py`, `_sweep_adaptive_cfg`). At the cell's
#: fixed SWEEP_UTIL every window would run hot and pin the ratio at 1.0.
PLANES_UTILS = (0.40, 0.41, 0.42, 0.43, 0.44, 0.45, 0.85, 0.85) + (0.40,) * 8
PLANES_ADAPTIVE = dict(window=8, min_history=3, hot_util=0.63, step_up=0.15,
                       step_down=0.5, ratio_max=3.0)
#: The mitigation ladder's arm of `benchmarks/serve_resources.py`
#: (`ladder`, cap -> balloon -> migrate): 2x emergency budget, admission
#: at LADDER_ADMIT_SPAN times its dynamic span. Its target is the
#: recorded arm in BENCH_serve_resources.json.
SIM_LADDER = dict(days=0.5, seed=0, deployments_per_hour=32.0,
                  prefill_core_ratio=0.5)
LADDER_ADMIT_SPAN = 1.3
#: The adaptive arm of `benchmarks/serve_adaptive.py` (`_sweep_arm` with
#: `_sweep_adaptive_cfg`, admission at the 2x budget), cut from its 1.25
#: days to 0.5: at 1.25 days it took 123.9 s of a 897 s script on the
#: H100's host. Its target is the reference's own output at 0.5 days,
#: from the JAX package on the CPU: `benchmarks/serve_adaptive.py` with
#: `SWEEP_DAYS = 0.5`, `_sweep_arm(_fixed_budget_w(1.0),
#: _sweep_adaptive_cfg(), False)`, run with `PYTHONPATH=src:.` and the
#: reference's `jax.experimental.enable_x64` (removed in jax 0.9) set to
#: `lambda: jax.enable_x64(True)`.
#: The ladder's target is the recorded arm (`ladder/cap-balloon-migrate`).
SIM_ADAPTIVE = dict(days=0.5, seed=0, deployments_per_hour=32.0,
                    prefill_core_ratio=0.4)
SIM_ADAPTIVE_TARGET = {"admitted": 1485, "failures": 1673,
                       "uf_throttled_s": 0.0,
                       "nuf_throttled_s": 700549.0984214912,
                       "migrations": 0, "final_ratio": 1.0, "ratchets": 190,
                       "backoffs": 203}


def streamed_planes(run, hist, arrivals, labels, budget_w: float, seed: int,
                    cell: dict, dev) -> dict:
    """The streamed cell with the ballooning rung and the adaptive
    controller (see `streamed`). First the rung alone on the streamed
    cell's own sweeps, beside that cell's numbers (`cell`, the `streamed_serve`
    result); then both planes with a sweep after every micro-batch at
    PLANES_UTILS, its launch counts read from 0, at 4 hosts, on the CPU
    (both with the first run's sweep powers) and once more on the card;
    then the launches of one cap window with each rung."""
    import torch
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.serve import (AdaptiveConfig, BallooningConfig,
                                   EmergencyConfig)
    from repro_torch.sim.telemetry import arrival_batch
    batch = arrival_batch(arrivals)
    ecfg = EmergencyConfig.from_model(EMERGENCY_BUDGET_W,
                                      dwell_s=STREAM_DWELL_S)
    bcfg, acfg = BallooningConfig(), AdaptiveConfig(**PLANES_ADAPTIVE)
    both = dict(emergency=ecfg, ballooning=bcfg, adaptive=acfg)
    warm_state, warm = warm_cluster(seed)

    def pipeline(hosts, device=dev, **planes):
        return _stream_pipeline(run, hist, labels, budget_w, warm_state,
                                warm, hosts, device, **planes)

    # the rung alone at the streamed cell's own sweeps (util SWEEP_UTIL)
    rung = streamed(pipeline(1, emergency=ecfg, ballooning=bcfg), batch, 1,
                    True, warm)
    check(rung["balloon_events"] >= 1,
          "the rung fires on the streamed cell's own sweeps")

    reset_launches()
    pipes = {"on_1": pipeline(1, **both)}
    runs = {"on_1": streamed(pipes["on_1"], batch, 1, True, warm,
                             utils=PLANES_UTILS, sweep_every=1)}
    launches = dict(KERNEL_LAUNCHES)
    on1, p1 = runs["on_1"], pipes["on_1"]
    check(launches["forest"] == on1["micro_batches"] == len(batch) // BATCH,
          f"streamed planes: a forest launch per micro-batch: {launches}")
    ast = p1.adaptive_state
    ratchets, backoffs = int(ast.ratchets), int(ast.backoffs)
    check(on1["balloon_events"] >= 1, "the ballooning rung fires")
    check(ratchets >= 1 and backoffs >= 1,
          f"the controller ratchets and backs off: {ratchets}, {backoffs}")
    for name, hosts, device, samples in (
            ("on_4", 4, dev, on1["samples"]),
            ("cpu", 1, "cpu", on1["samples"]),
            ("on_1_again", 1, dev, None)):
        pipes[name] = pipeline(hosts, device, **both)
        runs[name] = streamed(pipes[name], batch, hosts, True, warm,
                              samples, utils=PLANES_UTILS, sweep_every=1)

    def same(a, b, what):
        for f in ("servers", "conservative", "throttled_by_level"):
            check(np.array_equal(a[f], b[f]), f"{what}: equal {f}")
        check(a["alarms"] == b["alarms"] and a["cycle"] == b["cycle"],
              f"{what}: equal alarms and migration cycle")

    def tensors_equal(a, b, what):
        for f, x, y in zip(a._fields, a, b):
            check(torch.equal(x.cpu(), y.cpu()), f"{what}: equal {f}")
    for name in ("on_4", "on_1_again", "cpu"):
        same(runs[name], on1, f"streamed planes, {name} against on_1")
        p = pipes[name]
        for f in ("count", "head", "ratio", "ratchets", "backoffs"):
            check(torch.equal(getattr(p.adaptive_state, f).cpu(),
                              getattr(ast, f).cpu()),
                  f"streamed planes, {name}: adaptive {f} equal")
        if name == "cpu":
            continue
        tensors_equal(p.state, p1.state, f"streamed planes, {name} state")
        tensors_equal(p.emergency, p1.emergency, f"{name} emergency")
        tensors_equal(p.balloon_state, p1.balloon_state, f"{name} balloons")
        tensors_equal(p.adaptive_state, ast, f"{name} adaptive state")
    again = runs["on_1_again"]
    check(all(np.array_equal(a, b) for a, b in zip(again["samples"],
                                                   on1["samples"])),
          "the repeated run samples the same live aggregates, bit for bit")
    check(again["ratios"] == on1["ratios"]
          and again["balloon_events"] == on1["balloon_events"],
          "the repeated run ratchets and balloons alike")
    cpu = pipes["cpu"]
    gaps = {}
    for what, a, b in (
            *((f, getattr(p1.state, f), getattr(cpu.state, f))
              for f in ("free_cores", "gamma_uf", "gamma_nuf", "res_peak",
                        "mem_nuf")),
            ("ballooned_gb", p1.balloon_state.ballooned_gb,
             cpu.balloon_state.ballooned_gb),
            ("adaptive_util", ast.util, cpu.adaptive_state.util)):
        gaps[what] = float((a.cpu() - b).abs().max())
        check(gaps[what] <= 1e-6 * max(1.0, float(b.abs().max())),
              f"CPU final {what} within float32 rounding of the card's: "
              f"{gaps[what]}")

    # launches of one cap window (after a first one) with each rung, on a
    # pipeline that has served one micro-batch
    chassis = np.arange(N_SERVERS // BLADES)
    chunk = _rows(batch, np.arange(BATCH))
    hot = on1["samples"][PLANES_UTILS.index(0.85)]

    def window_launches(**planes):
        pipe = pipeline(1, **planes)
        pipe.submit_to(0, chunk, t=np.arange(1.0, BATCH + 1.0))

        def window(t):
            pipe.cap_to(0, chassis, hot, t=t + (chassis + 1) * 1e-7)
            return pipe.alarms
        window(BATCH + 0.5)
        return device_profile(lambda: None,
                              lambda: window(BATCH + 1.5))["launches"]
    per_window = {
        "emergency": window_launches(emergency=ecfg),
        "emergency_ballooning": window_launches(emergency=ecfg,
                                                ballooning=bcfg),
        "adaptive": window_launches(adaptive=acfg),
        "all": window_launches(**both)}
    cycle = on1["cycle"] or {}
    return {
        "arrivals": len(batch), "micro_batches": on1["micro_batches"],
        "sweeps": on1["sweeps"], "utils": list(PLANES_UTILS),
        "adaptive_cfg": PLANES_ADAPTIVE, "ballooning_cfg": {
            "w_per_gb": bcfg.w_per_gb, "reclaim_frac": bcfg.reclaim_frac},
        "budget_w": EMERGENCY_BUDGET_W, "admission_w": budget_w,
        "alarms": on1["alarms"],
        "throttled_by_level": on1["throttled_by_level"].tolist(),
        "admitted": int((on1["servers"] >= 0).sum()),
        "power_rejected": int((on1["servers"] == -2).sum()),
        "balloon_events": on1["balloon_events"],
        "ballooned_peak_gb": on1["ballooned_peak_gb"],
        "ballooned_gb_end": on1["ballooned_gb"],
        "ratios": on1["ratios"], "ratchets": ratchets, "backoffs": backoffs,
        "migration_moves": cycle.get("moves", 0),
        "due_chassis": len(cycle.get("due_chassis", [])),
        "launches": launches,
        "arrivals_per_s": {k: v["arrivals_per_s"] for k, v in runs.items()},
        "hosts_equal": True, "cpu_equal": True, "repeat_bit_equal": True,
        "cpu_state_max_gap": gaps,
        "launches_per_cap_window": per_window,
        "rung_only_at_cell_sweeps": {
            "alarms": rung["alarms"],
            "throttled_by_level": rung["throttled_by_level"].tolist(),
            "moves": (rung["cycle"] or {}).get("moves", 0),
            "admitted": int((rung["servers"] >= 0).sum()),
            "balloon_events": rung["balloon_events"],
            "ballooned_peak_gb": rung["ballooned_peak_gb"],
            "hot_sweeps": [n for n in rung["balloon_need"]
                           if n["demand_w_max"] > 0],
            "arrivals_per_s": rung["arrivals_per_s"],
            "cell_without_rung": {
                "alarms": cell["alarms"],
                "throttled_by_level": cell["throttled_by_level"],
                "moves": cell["migration_cycle"]["moves"],
                "admitted": cell["admitted"]}}}


def examples_phase(dev) -> dict:
    """The example twins on the card, each read from counts at 0, their
    printed lines captured, and the quickstart once more on the CPU; the
    training twins (`train_lm`: its loss must fall; `serve_capped`: the
    serving job at full frequency, the training job throttled) launch no
    hand-written kernel."""
    import contextlib
    import io
    import shutil

    import torch
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.examples import (datacenter_sim, quickstart,
                                      serve_capped, train_lm)
    out = {}
    ckpt = Path(__file__).resolve().parent / "build" / "examples_train_lm"
    for name, run in (
            ("train_lm", lambda: train_lm.main(
                ["--device", str(dev), "--ckpt-dir", str(ckpt)])),
            ("serve_capped", lambda: serve_capped.main(device=dev))):
        printed = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            nums = run()       # each twin raises unless its claim holds
        torch.cuda.synchronize()
        out[name] = {"seconds": time.perf_counter() - t0,
                     "launches": dict(KERNEL_LAUNCHES),
                     "printed": printed.getvalue().splitlines(),
                     "numbers": {"first_loss": nums[0],
                                 "last_20_mean_loss": float(
                                     np.mean(nums[-20:]))}
                     if name == "train_lm" else
                     {k: v for k, v in nums.items() if k != "losses"}}
        check(sum(out[name]["launches"].values()) == 0,
              f"{name} launches no hand-written kernel: "
              f"{out[name]['launches']}")
    shutil.rmtree(ckpt, ignore_errors=True)
    for name, mod in (("quickstart", quickstart),
                      ("datacenter_sim", datacenter_sim)):
        printed = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            nums = mod.main(device=dev)
        torch.cuda.synchronize()
        out[name] = {"seconds": time.perf_counter() - t0,
                     "launches": dict(KERNEL_LAUNCHES),
                     "printed": printed.getvalue().splitlines()}
        if name == "quickstart":
            out[name]["numbers"] = nums
            continue
        out[name]["numbers"] = {
            "crit_acc": nums["table3"]["criticality"]["accuracy_high_conf"],
            "p95_acc": nums["table3"]["p95"]["accuracy_high_conf"],
            "p95_pct_high_conf": nums["table3"]["p95"]["pct_high_conf"],
            **{f"{k}_{f}": getattr(nums[k], f)
               for k in ("sim_base", "sim_ours")
               for f in ("placements", "failures", "chassis_score_std",
                         "server_score_std")},
            "uf_p95_latency_x": nums["uf_p95_latency_x"],
            "nuf_slowdown": nums["nuf_slowdown"],
            "oversubscription": nums["oversubscription"]}
    q, d = out["quickstart"], out["datacenter_sim"]
    check(q["launches"]["forest"] > 0 and q["launches"]["template"] > 0,
          f"the quickstart runs the forest and template kernels: "
          f"{q['launches']}")
    check(d["launches"]["template"] > 0,
          f"the datacenter scenario labels on the card: {d['launches']}")
    qn = q["numbers"]
    check(qn["history"] == 600 and 0 < qn["uf_share"] < 1
          and 0 < qn["admitted"] <= 256 and qn["oversubscription"] > 0,
          f"quickstart numbers: {qn}")
    dn = d["numbers"]
    check(all(0 < dn[k] <= 1 for k in ("crit_acc", "p95_acc",
                                       "p95_pct_high_conf"))
          and dn["sim_ours_placements"] > 0
          and math.isfinite(dn["uf_p95_latency_x"]),
          f"datacenter numbers: {dn}")
    with contextlib.redirect_stdout(io.StringIO()):
        q["cpu_numbers"] = quickstart.main(device="cpu")
    check(q["cpu_numbers"] == qn,
          f"the quickstart on the card gives the CPU's numbers: {qn} vs "
          f"{q['cpu_numbers']}")
    return out


def sim_arms(dev) -> dict:
    """The ladder arm and the adaptive arm in `simulate` on the serve
    backend on the card, the ballooning and adaptive twins stepped and
    checked there at every scan, each compared field by field with its
    target."""
    from repro_torch.core.placement import SchedulerPolicy
    from repro_torch.core.power_model import F_MAX, idle_power
    from repro_torch.serve import (AdaptiveConfig, BallooningConfig,
                                   EmergencyConfig, ResourceVector)
    from repro_torch.sim import scheduler_sim as S
    static = BLADES * float(idle_power(F_MAX))
    root = Path(__file__).resolve().parent
    out = {}
    for name, spec_kw, admit_w in (
            ("sim_ladder", dict(ballooning=BallooningConfig(), **SIM_LADDER),
             static + LADDER_ADMIT_SPAN * (EMERGENCY_BUDGET_W - static)),
            ("sim_adaptive", dict(adaptive=AdaptiveConfig(**PLANES_ADAPTIVE),
                                  **SIM_ADAPTIVE), EMERGENCY_BUDGET_W)):
        t0 = time.perf_counter()
        m = S.simulate(SchedulerPolicy(), S.PredictionChannel("ml"),
                       S.SimSpec(serve=S.ServeBackendSpec(
                           backend="serve",
                           admission_budget=ResourceVector(watts=admit_w)),
                           emergency=EmergencyConfig.from_model(
                               EMERGENCY_BUDGET_W), **spec_kw), device=dev)
        secs = time.perf_counter() - t0
        mine = {"admitted": m.placements - m.failures,
                "failures": m.failures, "uf_throttled_s": m.uf_throttled_s,
                "nuf_throttled_s": m.nuf_throttled_s,
                "migrations": m.migrations}
        if name == "sim_ladder":
            mine.update(alarms=m.alarms, balloon_events=m.balloon_events,
                        balloon_reclaimed_gb=m.balloon_reclaimed_gb)
            record = next(a for a in json.loads(
                (root / "BENCH_serve_resources.json").read_text())
                ["ladder"]["arms"] if a["name"] == "ladder/cap-balloon-migrate")
            target = {k: record[k] for k in mine}
        else:
            mine.update(final_ratio=m.adaptive_ratio,
                        ratchets=m.adaptive_ratchets,
                        backoffs=m.adaptive_backoffs)
            record = next(a for a in json.loads(
                (root / "BENCH_serve_adaptive.json").read_text())
                ["sweep"]["arms"] if a["name"] == "adaptive")
            target = SIM_ADAPTIVE_TARGET
        for k in target:
            check(mine[k] == target[k],
                  f"{name}: {k} {mine[k]!r} == target {target[k]!r}")
        out[name] = {**(SIM_LADDER if name == "sim_ladder" else SIM_ADAPTIVE),
                     "admission_w": admit_w, "budget_w": EMERGENCY_BUDGET_W,
                     "seconds": secs, "placements": m.placements,
                     "arrivals_per_s": m.placements / secs,
                     "port": mine, "target": target,
                     "equal_to_target": True,
                     "reference_record": {k: v for k, v in record.items()
                                          if k != "wall_s"},
                     "alarms": m.alarms, "ballooned_gb_end": m.ballooned_gb}
    return out


#: Sharded serving: the serving cell through `ShardedServePipeline` at
#: SHARD_COUNTS shards, then at 4 shards under a cluster budget whose token
#: pool is SHARD_POOL_SHARE of the rho the 1-shard run admitted.
SHARD_COUNTS = (1, 2, 4)
SHARD_POOL_SHARE = 0.8
#: The streamed cell with both planes at PLANE_SHARDS shards over its first
#: SHARDED_STREAM_BATCHES micro-batches, a sweep after each: calm and
#: settling (the controllers ratchet), then hot (they back off, and the
#: rung fires).
PLANE_SHARDS, SHARDED_STREAM_BATCHES = 4, 4
SHARDED_PLANES_UTILS = (0.40, 0.41, 0.42, 0.85)
#: Fig 7 on the serve-sharded backend (alpha 0.8, `ml`, seed 0), its
#: launches read from a profiled run of SIM_SHARDED_PROFILE_DAYS, and the
#: cluster budget of the reference's test: a 400-rho token pool.
SIM_SHARDED_DAYS, SIM_SHARDED_PROFILE_DAYS = 0.25, 0.05
SIM_TOKEN_RHO = 400.0


def _sharded_serve_run(run, hist, budget_w, shards, dev, cluster_w=None,
                       profiled=False, mesh=None):
    """The serving cell's arrivals through a fresh `ShardedServePipeline`
    of `shards` shards on `dev`, in the main path's micro-batches; the
    cluster budget `cluster_w` (watts) when given; the whole run under the
    profiler when `profiled`; one shard a device of `mesh` when given.
    Returns the pipeline, the per-batch results, the wall, the batch
    latencies, the arrivals each batch spilled and the profile."""
    import torch
    from repro_torch.serve import (PlaneBundle, ResourceVector,
                                   ShardedServeConfig, ShardedServePipeline)
    pipe = ShardedServePipeline.from_history(
        run["svc"], hist, run["labels"], n_servers=N_SERVERS,
        cores_per_server=CORES, blades_per_chassis=BLADES, device=dev,
        config=ShardedServeConfig(batch_size=BATCH, n_shards=shards,
                                  planes=PlaneBundle(
            chassis_budget=ResourceVector(watts=budget_w),
            cluster_budget=None if cluster_w is None
            else ResourceVector(watts=cluster_w))),
        **({} if mesh is None else {"mesh": mesh}))
    parts, batch_ms, spilled, prof = [], [], [], None

    def serve_all():
        for chunk in micro_batches(run["batch"]):
            t0, before = time.perf_counter(), pipe.spill_info["spilled"]
            parts.append(pipe.serve(chunk))      # ends in a host fetch
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            spilled.append(pipe.spill_info["spilled"] - before)
    t_serve = time.perf_counter()
    if profiled:
        prof = device_profile(lambda: None, serve_all)
    else:
        serve_all()
    if str(dev) != "cpu":
        torch.cuda.synchronize()
    return (pipe, parts, time.perf_counter() - t_serve, batch_ms, spilled,
            prof)


def _outcomes(parts, cores) -> dict:
    """Decision counts of a served run and the rho it admitted."""
    servers = np.concatenate([p.server for p in parts])
    p95 = np.concatenate([p.p95_eff for p in parts]).astype(np.float64)
    adm = servers >= 0
    return {"admitted": int(adm.sum()),
            "capacity_rejected": int((servers == -1).sum()),
            "power_rejected": int((servers == -2).sum()),
            "token_rejected": int((servers == -3).sum()),
            "rho_admitted": float((p95 * cores)[adm].sum())}


def sharded_serve(run, hist, budget_w: float, main_servers, main_state,
                  extra, dev) -> dict:
    """The serving cell through `ShardedServePipeline` on the card: at 1
    shard it must give the main path's decisions and final state bit for
    bit; at 2 and 4 shards a CPU replay (2, and 4 under the budget) and a
    repeated card run must give the same; at 4 shards under a cluster
    budget (SHARD_POOL_SHARE of the 1-shard run's admitted rho) the
    admitted rho stays within the pool, tokens run out, arrivals spill,
    the pools account for every admission, and when every admitted VM
    departs they return to the pool. Each timed card run's
    launch counts read from 0; a forest launch per micro-batch. A
    repeated run goes under the profiler whole: its launches give
    launches per arrival and per micro-batch over the run, spills
    included, and its busy time over the timed run's wall the device idle
    share. Each run records the arrivals every micro-batch spilled. At 1
    shard, which never spills, a micro-batch after the cell's (`extra`)."""
    import torch
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.core.power_model import (F_MAX, ServerPowerModel,
                                              idle_power)
    from repro_torch.serve import rho_pool_from_budget
    cores = run["batch"].cores.astype(np.float64)
    n_batches = N_ARRIVALS // BATCH
    out, pipes, runs, results = {}, {}, {}, {}

    def card(name, shards, cluster_w=None, profiled=False):
        reset_launches()
        pipe, parts, wall, bm, spilled, prof = _sharded_serve_run(
            run, hist, budget_w, shards, dev, cluster_w, profiled)
        launches = dict(KERNEL_LAUNCHES)
        check(launches["forest"] == len(parts) == n_batches,
              f"{name}: a forest launch per micro-batch: {launches}")
        res = _outcomes(parts, cores)
        check(res["admitted"] + res["capacity_rejected"]
              + res["power_rejected"] + res["token_rejected"] == N_ARRIVALS,
              f"{name}: admitted + capacity + power + token == arrivals")
        out[name] = {**res, "shards": shards, "spill": pipe.spill_info,
                     "spilled_per_micro_batch": spilled,
                     "launches": launches}
        if prof is None:
            s = sorted(bm)
            out[name].update(
                arrivals_per_s=N_ARRIVALS / wall, wall_s=wall,
                batch_p50_ms=float(np.percentile(s, 50)),
                batch_p99_ms=float(np.percentile(s, 99)))
        pipes[name] = pipe
        runs[name] = np.concatenate([p.server for p in parts])
        results[name] = parts
        return pipe, prof

    for shards in SHARD_COUNTS:
        card(f"shards_{shards}", shards)
    check(np.array_equal(runs["shards_1"], main_servers),
          "1 shard: the main path's decisions for every arrival")
    for f, a, b in zip(main_state._fields, pipes["shards_1"].global_state(),
                       main_state):
        check(torch.equal(a, b), f"1 shard: final {f} bit-equal to the "
              "main path's")
    pool = SHARD_POOL_SHARE * out["shards_1"]["rho_admitted"]
    cluster_w = N_SERVERS * float(idle_power(F_MAX)) \
        + ServerPowerModel().p_dyn_per_core * pool
    pool = rho_pool_from_budget(cluster_w, N_SERVERS)
    pipe, _ = card("shards_4_budget", 4, cluster_w)
    b4 = out["shards_4_budget"]
    check(b4["rho_admitted"] <= pool * (1 + 1e-6),
          f"4 shards: admitted rho {b4['rho_admitted']} within the pool "
          f"{pool}")
    check(b4["token_rejected"] > 0, "4 shards: the pool runs out")
    check(pipe.spill_info["spilled"] > 0
          and pipe.spill_info["spill_admitted"] > 0,
          f"4 shards: arrivals spill and land: {pipe.spill_info}")
    left = float(pipe.pool_left().astype(np.float64).sum())
    check(abs(left - (pool - b4["rho_admitted"])) <= 1e-4 * pool,
          f"4 shards: pools left {left} == pool - admitted "
          f"{pool - b4['rho_admitted']}")
    b4.update(pool_rho=pool, cluster_budget_w=cluster_w, pool_left=left)

    # the CPU replays, and the repeated card runs with their profiles
    for name, shards, cw in (("shards_2", 2, None),
                             ("shards_4_budget", 4, cluster_w)):
        t0 = time.perf_counter()
        cpu, parts, _, _, _, _ = _sharded_serve_run(run, hist, budget_w,
                                                    shards, "cpu", cw)
        out[name]["cpu_serve_s"] = time.perf_counter() - t0
        check(np.array_equal(np.concatenate([p.server for p in parts]),
                             runs[name]),
              f"{name}: the CPU decides as the card")
        check(np.allclose(cpu.pool_left_vec(), pipes[name].pool_left_vec(),
                          rtol=1e-6, atol=1e-3),
              f"{name}: CPU pools within float32 rounding of the card's")
    for name, shards, cw in (("shards_2", 2, None), ("shards_4", 4, None),
                             ("shards_4_budget", 4, cluster_w)):
        again, prof = card(f"{name}_again", shards, cw, profiled=True)
        check(np.array_equal(runs[f"{name}_again"], runs[name]),
              f"{name}: a repeated card run decides alike")
        for f, a, b in zip(again.global_state()._fields,
                           again.global_state(),
                           pipes[name].global_state()):
            check(torch.equal(a, b), f"{name}: repeated final {f} "
                  "bit-equal")
        check(torch.equal(again.sharded.pool, pipes[name].sharded.pool),
              f"{name}: repeated pools bit-equal")
        busy = prof["device_busy_ms"]
        wall = out[name]["wall_s"] * 1e3
        out[name]["profile"] = {
            "whole_run": True,
            "launches_per_micro_batch": prof["launches"] / n_batches,
            "launches_per_arrival": prof["launches"] / N_ARRIVALS,
            "device_busy_ms": busy, "run_wall_ms": wall,
            "device_idle_share": 1.0 - busy / wall
            if isinstance(busy, float) else "not measured",
            "top_device_ms": prof["top_device_ms"]}
    # every VM the budgeted run admitted departs: each shard's pool gets
    # back what it gave, and the cluster is empty again
    pipe, parts = pipes["shards_4_budget"], results["shards_4_budget"]
    srv = runs["shards_4_budget"]
    adm = srv >= 0
    peak = float(pipe.global_state().res_peak.abs().max())
    pipe.depart(srv[adm], cores[adm],
                np.concatenate([p.p95_eff for p in parts])[adm],
                np.concatenate([p.workload_type for p in parts])[adm] == 1,
                mem_gb=run["batch"].memory_gb[adm])
    back = float(pipe.pool_left().astype(np.float64).sum())
    st = pipe.global_state()
    check(abs(back - pool) <= 1e-4 * pool,
          f"4 shards: departures credit the pools back to {back} of {pool}")
    left_over = float(st.res_peak.abs().max())
    check(bool((st.free_cores == CORES).all()) and left_over <= 1e-5 * peak,
          f"4 shards: the departed cluster is empty (ledger {left_over} "
          f"left of {peak}: float32 rounding)")
    b4["pool_left_after_departures"] = back
    prof = serve_profile(pipes["shards_1"], *extra)
    prof["launches_per_micro_batch"] = prof["launches_per_arrival"] * BATCH
    out["shards_1"]["profile"] = prof
    out["pool_share"] = SHARD_POOL_SHARE
    out["checks"] = {"one_shard_equals_main_path": True,
                     "budget_held": True, "tokens_conserved": True,
                     "cpu_equal": True, "repeat_bit_equal": True}
    return out


def sharded_planes(run, hist, arrivals, labels, budget_w: float, seed: int,
                   dev) -> dict:
    """The streamed cell with both planes (`streamed_planes`'s) at
    PLANE_SHARDS shards over SHARDED_STREAM_BATCHES micro-batches, a sweep
    after each at SHARDED_PLANES_UTILS: its launch counts read from 0,
    then at 4 hosts and on the CPU with the first run's sweep powers, whose
    decisions, alarms, throttled-seconds and plane states must agree; the
    rung must fire and the per-shard controllers ratchet and back off. At
    1 shard the sharded pipeline must decide as the unsharded one (and
    sample the same powers). Then the launches of one standalone cap
    window at PLANE_SHARDS shards with each rung."""
    import torch
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.serve import (AdaptiveConfig, BallooningConfig,
                                   EmergencyConfig)
    from repro_torch.sim.telemetry import arrival_batch
    batch = _rows(arrival_batch(arrivals),
                  np.arange(SHARDED_STREAM_BATCHES * BATCH))
    ecfg = EmergencyConfig.from_model(EMERGENCY_BUDGET_W,
                                      dwell_s=STREAM_DWELL_S)
    bcfg, acfg = BallooningConfig(), AdaptiveConfig(**PLANES_ADAPTIVE)
    both = dict(emergency=ecfg, ballooning=bcfg, adaptive=acfg)
    warm_state, warm = warm_cluster(seed)
    kw = dict(utils=SHARDED_PLANES_UTILS, sweep_every=1)

    def pipeline(hosts, shards=PLANE_SHARDS, device=dev, **planes):
        return _stream_pipeline(run, hist, labels, budget_w, warm_state,
                                warm, hosts, device, shards,
                                **(planes or both))

    reset_launches()
    p4 = pipeline(1)
    on4 = streamed(p4, batch, 1, True, warm, **kw)
    launches = dict(KERNEL_LAUNCHES)
    check(launches["forest"] == on4["micro_batches"]
          == SHARDED_STREAM_BATCHES,
          f"sharded planes: a forest launch per micro-batch: {launches}")
    ast = p4.adaptive_state
    ratchets, backoffs = ast.ratchets.tolist(), ast.backoffs.tolist()
    check(on4["balloon_events"] >= 1, "sharded planes: the rung fires")
    check(sum(ratchets) >= 1 and sum(backoffs) >= 1,
          f"sharded planes: a shard's ratio ratchets and one backs off: "
          f"{ratchets}, {backoffs}")
    pipes, runs = {"on_4": p4}, {"on_4": on4}
    for name, hosts, device in (("hosts_4", 4, dev), ("cpu", 1, "cpu")):
        pipes[name] = pipeline(hosts, device=device)
        runs[name] = streamed(pipes[name], batch, hosts, True, warm,
                              on4["samples"], **kw)

    def same(a, b, what, ratios=True):
        """Equal decisions, throttled-seconds and alarms; and the ratios
        read after each sweep, where both runs read them at one point of
        the stream (a 4-host run applies a sweep when every host's clock
        has passed it, so it reads them later)."""
        for f in ("servers", "conservative", "throttled_by_level"):
            check(np.array_equal(a[f], b[f]), f"{what}: equal {f}")
        check(a["alarms"] == b["alarms"], f"{what}: equal alarms "
              f"{a['alarms']}, {b['alarms']}")
        check(not ratios or len(a["ratios"]) == len(b["ratios"]) and all(
            np.array_equal(np.ravel(x), np.ravel(y))
            for x, y in zip(a["ratios"], b["ratios"])),
            f"{what}: equal ratios")

    def planes_equal(p, q, what):
        for name, x, y in (("state", p.global_state(), q.global_state()),
                           ("emergency", p.emergency, q.emergency),
                           ("balloons", p.balloon_state, q.balloon_state),
                           ("adaptive", p.adaptive_state, q.adaptive_state)):
            for f, a, b in zip(x._fields, x, y):
                check(torch.equal(a.cpu(), b.cpu().reshape(a.shape)),
                      f"{what}: {name} {f} equal")
    same(runs["hosts_4"], on4, "sharded planes, 4 hosts against 1",
         ratios=False)
    planes_equal(pipes["hosts_4"], p4, "sharded planes, 4 hosts")
    same(runs["cpu"], on4, "sharded planes, the CPU against the card")
    cpu = pipes["cpu"]
    for f in ("count", "head", "ratio", "ratchets", "backoffs"):
        check(torch.equal(getattr(cpu.adaptive_state, f),
                          getattr(ast, f).cpu()),
              f"sharded planes, CPU: adaptive {f} equal")
    for f in ("pstate", "rapl"):
        check(torch.equal(getattr(cpu.emergency, f),
                          getattr(p4.emergency, f).cpu()),
              f"sharded planes, CPU: emergency {f} equal")
    gaps = {}
    for what, a, b in (
            *((f, getattr(p4.global_state(), f),
               getattr(cpu.global_state(), f))
              for f in ("free_cores", "gamma_uf", "gamma_nuf", "res_peak",
                        "mem_nuf")),
            ("ballooned_gb", p4.balloon_state.ballooned_gb,
             cpu.balloon_state.ballooned_gb),
            ("adaptive_util", ast.util, cpu.adaptive_state.util)):
        gaps[what] = float((a.cpu() - b).abs().max())
        check(gaps[what] <= 1e-6 * max(1.0, float(b.abs().max())),
              f"sharded planes: CPU final {what} within float32 rounding "
              f"of the card's: {gaps[what]}")

    # one shard against the unsharded pipeline on the same stream
    unsharded, one = pipeline(1, None), pipeline(1, 1)
    runs["unsharded"] = streamed(unsharded, batch, 1, True, warm, **kw)
    runs["shards_1"] = streamed(one, batch, 1, True, warm, **kw)
    same(runs["shards_1"], runs["unsharded"], "1 shard against unsharded")
    check(all(np.array_equal(a, b) for a, b in zip(
        runs["shards_1"]["samples"], runs["unsharded"]["samples"])),
        "1 shard samples the unsharded run's live aggregates, bit for bit")
    for name, x, y in (("state", one.global_state(), unsharded.state),
                       ("emergency", one.emergency, unsharded.emergency),
                       ("balloons", one.balloon_state,
                        unsharded.balloon_state),
                       ("adaptive", one.adaptive_state,
                        unsharded.adaptive_state)):
        for f, a, b in zip(x._fields, x, y):
            check(torch.equal(a.reshape(b.shape), b),
                  f"1 shard: {name} {f} equal to the unsharded run's")

    # launches of one standalone cap window at PLANE_SHARDS shards, after
    # a first one, on a pipeline that has served one micro-batch
    chassis = np.arange(N_SERVERS // BLADES)
    chunk = _rows(batch, np.arange(BATCH))
    hot = on4["samples"][-1]

    def window_launches(**planes):
        pipe = pipeline(1, **planes)
        pipe.submit_to(0, chunk, t=np.arange(1.0, BATCH + 1.0))

        def window(t):
            pipe.cap_to(0, chassis, hot, t=t + (chassis + 1) * 1e-7)
            return pipe.alarms
        window(BATCH + 0.5)
        return device_profile(lambda: None,
                              lambda: window(BATCH + 1.5))["launches"]
    per_window = {
        "emergency": window_launches(emergency=ecfg),
        "emergency_ballooning": window_launches(emergency=ecfg,
                                                ballooning=bcfg),
        "adaptive": window_launches(adaptive=acfg),
        "all": window_launches(**both)}
    return {
        "shards": PLANE_SHARDS, "arrivals": len(batch),
        "micro_batches": on4["micro_batches"], "sweeps": on4["sweeps"],
        "utils": list(SHARDED_PLANES_UTILS), "alarms": on4["alarms"],
        "throttled_by_level": on4["throttled_by_level"].tolist(),
        "admitted": int((on4["servers"] >= 0).sum()),
        "power_rejected": int((on4["servers"] == -2).sum()),
        "balloon_events": on4["balloon_events"],
        "ballooned_peak_gb": on4["ballooned_peak_gb"],
        "ratios": [np.ravel(r).tolist() for r in on4["ratios"]],
        "ratchets": ratchets, "backoffs": backoffs, "launches": launches,
        "arrivals_per_s": {k: v["arrivals_per_s"] for k, v in runs.items()},
        "hosts_equal": True, "cpu_equal": True,
        "one_shard_equals_unsharded": True, "cpu_state_max_gap": gaps,
        "launches_per_cap_window": per_window}


#: The mesh leg of sharded serving (`sharded_mesh`): one shard a mesh
#: position, over one card repeated and, where the machine has them, over
#: MESH_SHARDS distinct cards.
MESH_SHARDS = 4
MESH_ONE_CARD = ("cuda:0",) * MESH_SHARDS


def sharded_mesh(run, hist, arrivals, labels, budget_w: float, shard_serve,
                 shard_planes, extra, seed: int, dev) -> dict:
    """The mesh leg of sharded serving. The budgeted 4-shard serving cell
    (`sharded_serve`'s `shards_4_budget`: its cluster budget, the main
    path's micro-batches) through `ShardedServePipeline(mesh=shard_mesh(4,
    devices=MESH_ONE_CARD))`, the table row-partitioned over the mesh,
    its launch counts read from 0: a forest launch per micro-batch, and
    the decisions, final state, pools left and spill counters of a
    batch-axis card run on the same inputs, whose outcomes must be
    `sharded_serve`'s. Arrivals/s and batch p50/p99 of both legs; launches
    per arrival and the device idle share of each on a micro-batch after
    the cell (`extra`), after which both must still agree. Then the
    both-planes streamed arm of `sharded_planes` (PLANE_SHARDS shards,
    SHARDED_PLANES_UTILS) on the mesh against a batch-axis run of it,
    whose decisions, alarms and ratios must be `sharded_planes`':
    decisions, alarms, throttled-seconds, ratios, the final state and
    every plane state. With MESH_SHARDS cards the served cell again over
    cuda:0..3; with fewer, why it did not run."""
    import torch
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.serve import (AdaptiveConfig, BallooningConfig,
                                   EmergencyConfig, ShardedTable, shard_mesh)
    from repro_torch.sim.telemetry import arrival_batch
    cores = run["batch"].cores.astype(np.float64)
    n_batches = N_ARRIVALS // BATCH
    cell = shard_serve["shards_4_budget"]
    out, served = {}, {}

    def serve(name, mesh):
        reset_launches()
        pipe, parts, wall, bm, _, _ = _sharded_serve_run(
            run, hist, budget_w, MESH_SHARDS, dev, cell["cluster_budget_w"],
            mesh=mesh)
        launches = dict(KERNEL_LAUNCHES)
        check(launches["forest"] == len(parts) == n_batches,
              f"sharded_mesh {name}: a forest launch per micro-batch: "
              f"{launches}")
        s = sorted(bm)
        out[name] = {**_outcomes(parts, cores), "spill": pipe.spill_info,
                     "launches": launches, "arrivals_per_s": N_ARRIVALS / wall,
                     "wall_s": wall,
                     "batch_p50_ms": float(np.percentile(s, 50)),
                     "batch_p99_ms": float(np.percentile(s, 99)),
                     "mesh": None if mesh is None else [str(d) for d in mesh]}
        served[name] = (pipe, np.concatenate([p.server for p in parts]))
        return pipe

    def agree(name, what=""):
        """Decisions, final state, pools left and spill counters of the
        `name` run equal the batch axis's, bit for bit."""
        (pipe, srv), (base, base_srv) = served[name], served["batch_axis"]
        check(np.array_equal(srv, base_srv),
              f"sharded_mesh {name}{what}: the batch axis's decisions")
        for f, a, b in zip(base.global_state()._fields, pipe.global_state(),
                           base.global_state()):
            check(torch.equal(a, b), f"sharded_mesh {name}{what}: final "
                  f"{f} bit-equal to the batch axis's")
        check(np.array_equal(pipe.pool_left_vec(), base.pool_left_vec()),
              f"sharded_mesh {name}{what}: pools left bit-equal to the "
              "batch axis's")
        check(pipe.spill_info == base.spill_info,
              f"sharded_mesh {name}{what}: spill counters "
              f"{pipe.spill_info} == {base.spill_info}")

    serve("batch_axis", None)
    for k in ("admitted", "capacity_rejected", "power_rejected",
              "token_rejected"):
        check(out["batch_axis"][k] == cell[k],
              f"sharded_mesh: the batch-axis run's {k} "
              f"{out['batch_axis'][k]} is sharded_serve's {cell[k]}")
    one = serve("one_card", shard_mesh(MESH_SHARDS, devices=MESH_ONE_CARD))
    check(len(one.sharded.groups) == MESH_SHARDS
          and isinstance(one.table, ShardedTable),
          "sharded_mesh: the shards and the table lie on the mesh")
    agree("one_card")
    # where a micro-batch's time goes, on one after the cell, on each leg
    prof = {name: serve_profile(served[name][0], *extra)
            for name in ("batch_axis", "one_card")}
    for name, p in prof.items():
        out[name]["profile"] = {**p, "micro_batch": "after the cell"}
    out["launch_ratio"] = prof["one_card"]["launches_per_arrival"] \
        / prof["batch_axis"]["launches_per_arrival"]
    agree("one_card", " after two more micro-batches")

    # the both-planes streamed arm on either leg
    batch = _rows(arrival_batch(arrivals),
                  np.arange(SHARDED_STREAM_BATCHES * BATCH))
    both = dict(emergency=EmergencyConfig.from_model(
        EMERGENCY_BUDGET_W, dwell_s=STREAM_DWELL_S),
        ballooning=BallooningConfig(),
        adaptive=AdaptiveConfig(**PLANES_ADAPTIVE))
    warm_state, warm = warm_cluster(seed)
    arms = {}
    for name, mesh in (("batch_axis", None), ("one_card", MESH_ONE_CARD)):
        reset_launches()
        pipe = _stream_pipeline(run, hist, labels, budget_w, warm_state,
                                warm, 1, dev, PLANE_SHARDS,
                                mesh=None if mesh is None
                                else shard_mesh(PLANE_SHARDS, devices=mesh),
                                **both)
        arms[name] = (pipe, streamed(
            pipe, batch, 1, True, warm,
            arms["batch_axis"][1]["samples"] if arms else None,
            utils=SHARDED_PLANES_UTILS, sweep_every=1))
        arms[name][1]["launches"] = dict(KERNEL_LAUNCHES)
    (base, b), (mesh_pipe, m) = arms["batch_axis"], arms["one_card"]
    check(b["alarms"] == shard_planes["alarms"]
          and int((b["servers"] >= 0).sum()) == shard_planes["admitted"]
          and [np.ravel(r).tolist() for r in b["ratios"]]
          == shard_planes["ratios"],
          "sharded_mesh planes: the batch-axis arm is sharded_planes'")
    check(m["launches"]["forest"] == m["micro_batches"]
          == SHARDED_STREAM_BATCHES,
          f"sharded_mesh planes: a forest launch per micro-batch: "
          f"{m['launches']}")
    for f in ("servers", "conservative", "throttled_by_level"):
        check(np.array_equal(m[f], b[f]),
              f"sharded_mesh planes: the batch axis's {f}")
    check(m["alarms"] == b["alarms"] and len(m["ratios"]) == len(b["ratios"])
          and all(np.array_equal(x, y) for x, y in zip(m["ratios"],
                                                       b["ratios"])),
          "sharded_mesh planes: the batch axis's alarms and ratios")
    for what, x, y in (
            ("state", mesh_pipe.global_state(), base.global_state()),
            ("emergency", mesh_pipe.emergency, base.emergency),
            ("balloons", mesh_pipe.balloon_state, base.balloon_state),
            ("adaptive", mesh_pipe.adaptive_state, base.adaptive_state)):
        for f, a, c in zip(x._fields, x, y):
            check(torch.equal(a, c), f"sharded_mesh planes: {what} {f} "
                  "bit-equal to the batch axis's")
    check(np.array_equal(mesh_pipe.pool_left_vec(), base.pool_left_vec()),
          "sharded_mesh planes: pools left bit-equal to the batch axis's")
    out["planes"] = {
        name: {"arrivals_per_s": r["arrivals_per_s"], "wall_s": r["wall"],
               "alarms": r["alarms"], "launches": r["launches"],
               "admitted": int((r["servers"] >= 0).sum()),
               "balloon_events": r["balloon_events"]}
        for name, (_, r) in arms.items()}

    cards = torch.cuda.device_count()
    if cards >= MESH_SHARDS:
        serve("cards", shard_mesh(MESH_SHARDS))
        agree("cards")
        out["cards"]["run"] = True
    else:
        out["cards"] = {"run": False, "why": f"the machine has {cards} "
                        f"card(s); a mesh of distinct cards takes "
                        f"{MESH_SHARDS}"}
    out["checks"] = {"decisions_equal": True, "state_bit_equal": True,
                     "pools_bit_equal": True, "planes_bit_equal": True}
    return out


def sim_sharded(dev) -> dict:
    """The Fig 7 simulation on the serve-sharded backend on the card over
    SIM_SHARDED_DAYS: 1 shard gives the event trace; a CPU run gives the
    4-shard trace; under the
    reference test's cluster budget the pools reject placements while the
    per-group token conservation check holds. Launches per arrival at 1
    and 4 shards from profiled runs of SIM_SHARDED_PROFILE_DAYS."""
    import torch
    from repro_torch.core.placement import SchedulerPolicy
    from repro_torch.core.power_model import (F_MAX, ServerPowerModel,
                                              idle_power)
    from repro_torch.core.resources import ResourceVector
    from repro_torch.sim import scheduler_sim as S
    pol, ch = SchedulerPolicy(alpha=0.8), S.PredictionChannel("ml")
    n_servers = S.RACKS * S.CHASSIS_PER_RACK * S.BLADES_PER_CHASSIS
    budget_w = n_servers * float(idle_power(F_MAX)) \
        + ServerPowerModel().p_dyn_per_core * SIM_TOKEN_RHO
    out, traces = {"days": SIM_SHARDED_DAYS}, {}

    def sim(name, device, days=SIM_SHARDED_DAYS, **serve):
        tr = []
        t0 = time.perf_counter()
        m = S.simulate(pol, ch, S.SimSpec(
            days=days, seed=0, serve=S.ServeBackendSpec(**serve)),
            trace=tr, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        traces[name] = tr
        out[name] = {"seconds": wall, "arrivals_per_s": m.placements / wall,
                     "placements": m.placements, "failures": m.failures,
                     "failure_rate": m.failure_rate}
        return m
    sim("event", dev)
    sim("shards_1", dev, backend="serve-sharded", shards=1)
    sim("shards_4", dev, backend="serve-sharded", shards=4)
    sim("shards_4_cpu", "cpu", backend="serve-sharded", shards=4)
    sim("shards_4_budget", dev, backend="serve-sharded", shards=4,
        cluster_budget=ResourceVector(watts=budget_w))
    check(traces["shards_1"] == traces["event"],
          "serve-sharded at 1 shard on the card gives the event trace")
    check(traces["shards_4_cpu"] == traces["shards_4"],
          "the 4-shard trace on the card equals the CPU's")
    check(out["shards_4_budget"]["failures"] > 0
          and -3 in traces["shards_4_budget"],
          "the cluster budget's pools reject placements (FAIL_TOKENS)")
    out["shards_4_budget"].update(budget_w=budget_w,
                                  token_rejected=traces["shards_4_budget"]
                                  .count(-3), conservation_held=True)
    for shards in (1, 4):
        runs = []
        prof = device_profile(lambda: runs.append(S.simulate(
            pol, ch, S.SimSpec(days=SIM_SHARDED_PROFILE_DAYS, seed=0,
                               serve=S.ServeBackendSpec(
                                   backend="serve-sharded", shards=shards)),
            device=dev)))
        n = runs[-1].placements
        out[f"shards_{shards}"]["profile"] = {
            "days": SIM_SHARDED_PROFILE_DAYS, "placements": n,
            "launches_per_arrival": prof["launches"] / n,
            "device_idle_share": prof["device_idle_share"],
            "wall_ms": prof["wall_ms"]}
    out["traces_equal"] = True
    return out


#: The observability phases (`obs_serve`, `obs_streamed`, `obs_sharded`,
#: `monitor`): the main path's decisions at seed 0 (PERF.md §5);
#: the monitor CLI's sim (4 shards, MONITOR_DAYS days) and the families
#: its Prometheus text must hold.
MAIN_PATH_OUTCOMES = {"admitted": 3340, "conservative": 969}
#: Passes of `obs_serve`'s timed pairs: each micro-batch served by an
#: obs-off and an obs-on pipeline back to back, either first in turn, so
#: the host's drift within a call falls on both sides of every pair.
OBS_SERVE_PASSES = 3
MONITOR_SHARDS, MONITOR_DAYS = 4, 0.25
MONITOR_FAMILIES = ("serve_dispatch_total", "serve_span_seconds",
                    "emergency_alarms_total",
                    "emergency_throttled_seconds_total", "adaptive_ratio",
                    "adaptive_ratchet_total", "quality_scored",
                    "sim_pred_crit_accuracy", "slo_burn_rate")


def obs_serve(run, hist, budget_w: float, main_servers, main_state,
              main_conservative: int, extra, seed: int, dev) -> dict:
    """The serving cell with `Observability.full()` on the card: its
    decisions and final state must be the main path's bit for bit, its
    counters those decisions (at seed 0 the MAIN_PATH_OUTCOMES), every
    arrival scored, and the scorecard's high-confidence criticality
    counters `core.forest.evaluate`'s on the same featurized arrivals.
    The overhead: over OBS_SERVE_PASSES passes, fresh obs-off and obs-on
    pipelines serve each micro-batch back to back (either first in
    turn); each pair's on/off wall ratio, its median and quartiles, and
    arrivals/s per pass. The launches of one micro-batch (`extra[0]`)
    with obs off and on, after equal runs. The obs-on path's launch
    counts are read from 0 around each of its micro-batches of the first
    pass."""
    import torch
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.core.forest import evaluate
    from repro_torch.obs import Observability
    from repro_torch.serve import (PlaneBundle, ResourceVector, ServeConfig,
                                   ServePipeline, featurize_batch)

    def pipeline(obs):
        return ServePipeline.from_history(
            run["svc"], hist, run["labels"], n_servers=N_SERVERS,
            cores_per_server=CORES, blades_per_chassis=BLADES, device=dev,
            config=ServeConfig(batch_size=BATCH, planes=PlaneBundle(
                chassis_budget=ResourceVector(watts=budget_w), obs=obs)))

    obs = Observability.full()
    chunks = list(micro_batches(run["batch"]))
    ms = {"off": [], "on": []}
    checked, launches = [], {k: 0 for k in KERNEL_LAUNCHES}
    for rnd in range(OBS_SERVE_PASSES):
        pipes = {"off": pipeline(None),
                 "on": pipeline(obs if rnd == 0 else Observability.full())}
        if rnd == 0:
            checked_pipe = pipes["on"]
        for k, chunk in enumerate(chunks):
            for name in (("off", "on") if (k + rnd) % 2 == 0
                         else ("on", "off")):
                first = rnd == 0 and name == "on"
                if first:
                    reset_launches()
                t0 = time.perf_counter()
                res = pipes[name].serve(chunk)   # ends in a host copy
                ms[name].append((time.perf_counter() - t0) * 1e3)
                if first:
                    checked.append(res)
                    for kern, n in KERNEL_LAUNCHES.items():
                        launches[kern] += n
    torch.cuda.synchronize()
    ratios = np.array(ms["on"]) / np.array(ms["off"])
    servers = np.concatenate([p.server for p in checked])
    check(np.array_equal(servers, main_servers),
          "obs_serve: the main path's decision for every arrival")
    for f, a, b in zip(main_state._fields, checked_pipe.state, main_state):
        check(torch.equal(a, b), f"obs_serve: final {f} bit-equal to the "
              "main path's")
    n_batches = N_ARRIVALS // BATCH
    check(launches["forest"] == n_batches,
          f"obs_serve: a forest launch per micro-batch: {launches}")
    v = obs.registry.value
    admitted = int((main_servers >= 0).sum())
    rejects = {r: int(v("serve_rejects_total", reason=r))
               for r in ("capacity", "power", "tokens")}
    counters = {"arrivals": int(v("serve_arrivals_total")),
                "admits": int(v("serve_admits_total")),
                "conservative": int(v("serve_conservative_total")),
                "batches": int(v("serve_batches_total")),
                "rejects": rejects}
    check(counters["arrivals"] == N_ARRIVALS
          and counters["admits"] == admitted
          and counters["conservative"] == main_conservative
          and counters["batches"] == n_batches,
          f"obs_serve: counters are the main path's decisions: {counters}")
    check(sum(rejects.values()) == N_ARRIVALS - admitted,
          f"obs_serve: rejects by reason sum to {N_ARRIVALS - admitted}: "
          f"{rejects}")
    if seed == 0:
        check(admitted == MAIN_PATH_OUTCOMES["admitted"]
              and main_conservative == MAIN_PATH_OUTCOMES["conservative"],
              f"obs_serve: {admitted} admitted, {main_conservative} "
              f"conservative at seed 0: {MAIN_PATH_OUTCOMES}")
    card = obs.quality
    check(card.n_scored == N_ARRIVALS,
          f"obs_serve: every arrival scored: {card.n_scored}")
    check(obs.audit.total_recorded == N_ARRIVALS,
          "obs_serve: an audit row per arrival")
    online = card.offline_style("crit")
    x = featurize_batch(checked_pipe.table, run["batch"]).cpu().numpy()
    y = np.asarray(run["batch"].user_facing, np.int64)
    svc = run["svc"]
    offline = evaluate(svc.criticality, x, y,
                       confidence=svc.confidence_gate)
    for k in ("pct_high_conf", "accuracy_high_conf"):
        check(math.isclose(online[k], offline[k], rel_tol=1e-9),
              f"obs_serve: scorecard {k} {online[k]} == evaluate's "
              f"{offline[k]}")
    for c, vals in offline["buckets"].items():
        for k in ("recall", "precision"):
            got = online["buckets"][c][k]
            check(math.isclose(got, vals[k], rel_tol=1e-9),
                  f"obs_serve: class {c} {k} {got} == evaluate's {vals[k]}")
    spans = {k: {"count": int(n), "total_s": s}
             for k, (n, s) in obs.tracer.totals().items()}
    check(all(spans.get(k, {}).get("count") == n_batches
              for k in ("featurize", "infer", "place", "commit")),
          f"obs_serve: a span of each stage per micro-batch: {spans}")
    # launches of one more micro-batch with obs off and on, on pipelines
    # that have served the same arrivals
    per_batch = {
        name: device_profile(lambda: None, lambda p=pipes[name]: p.serve(
            extra[0]))["launches"] for name in ("off", "on")}
    check(per_batch["on"] >= per_batch["off"],
          f"obs_serve: launches per micro-batch {per_batch}")
    n_chunks = len(chunks)
    return {
        "arrivals": N_ARRIVALS, "micro_batches": n_batches,
        "admitted": admitted, "conservative": main_conservative,
        "counters": counters, "scored": card.n_scored,
        "scorecard": {"crit_accuracy": card.crit_accuracy,
                      "p95_accuracy": card.p95_accuracy,
                      "model_stale": card.model_stale,
                      "drift": card.drift(), "offline_style": online},
        "evaluate": offline, "spans": spans,
        "arrivals_per_s": {k: [N_ARRIVALS * 1e3 / sum(
            v[i * n_chunks:(i + 1) * n_chunks]) for i in range(
                OBS_SERVE_PASSES)] for k, v in ms.items()},
        "batch_p50_ms": {k: float(np.median(v)) for k, v in ms.items()},
        "pairs": len(ratios),
        "overhead_share": float(np.median(ratios)) - 1.0,
        "overhead_share_quartiles": (np.percentile(ratios, [25, 75])
                                     - 1.0).tolist(),
        "pairs_on_slower": int((ratios > 1.0).sum()),
        "launches": launches, "launches_per_micro_batch": per_batch,
        "extra_launches_per_micro_batch": per_batch["on"]
        - per_batch["off"],
        "decisions_equal_main_path": True, "scorecard_reconciles": True}


def obs_streamed(run, hist, arrivals, labels, budget_w: float, seed: int,
                 dev) -> dict:
    """The streamed cell with both planes (`streamed_planes`'s) and
    `Observability.full()` at 1 and 4 hosts against the same cell with
    obs off: equal decisions, conservative flags, alarms,
    throttled-seconds and migration cycle; the sweep counters those of
    the plane (alarms `pipe.alarms`, one window of the 60 chassis per
    sweep, the watts removed covering the demand no floor left over);
    and the flight recorder replayed through a fresh card pipeline
    (`verify_replay`) gives the recorded decisions. The launch counts
    read from 0 around the 1-host obs run."""
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.obs import LEVEL_NAMES, Observability
    from repro_torch.obs.recorder import verify_replay
    from repro_torch.serve import (AdaptiveConfig, BallooningConfig,
                                   EmergencyConfig)
    from repro_torch.sim.telemetry import arrival_batch
    batch = arrival_batch(arrivals)
    both = dict(emergency=EmergencyConfig.from_model(
        EMERGENCY_BUDGET_W, dwell_s=STREAM_DWELL_S),
        ballooning=BallooningConfig(),
        adaptive=AdaptiveConfig(**PLANES_ADAPTIVE))
    warm_state, warm = warm_cluster(seed)
    kw = dict(utils=PLANES_UTILS, sweep_every=1)
    n_chassis = N_SERVERS // BLADES

    def pipeline(hosts, obs=None):
        return _stream_pipeline(run, hist, labels, budget_w, warm_state,
                                warm, hosts, dev, obs=obs, **both)
    off = streamed(pipeline(1), batch, 1, True, warm, **kw)
    out, launches = {"off": {"arrivals_per_s": off["arrivals_per_s"]}}, None
    for hosts in STREAM_HOSTS:
        obs = Observability.full()
        pipe = pipeline(hosts, obs)
        if hosts == 1:
            reset_launches()
        r = streamed(pipe, batch, hosts, True, warm, off["samples"], **kw)
        if hosts == 1:
            launches = dict(KERNEL_LAUNCHES)
        what = f"obs_streamed, {hosts} hosts"
        for f in ("servers", "conservative", "throttled_by_level"):
            check(np.array_equal(r[f], off[f]), f"{what}: equal {f}")
        check(r["alarms"] == off["alarms"] and r["cycle"] == off["cycle"],
              f"{what}: equal alarms and migration cycle")
        v = obs.registry.value
        sweep = {k: v(f"emergency_{k}_total") for k in (
            "alarms", "cap_windows", "samples", "cut_watts",
            "leftover_watts")}
        removed = sum(v("emergency_level_cut_watts_total", level=lv)
                      for lv in LEVEL_NAMES)
        check(sweep["alarms"] == r["alarms"] == pipe.alarms,
              f"{what}: alarm counter {sweep['alarms']} == the plane's "
              f"{r['alarms']}")
        check(sweep["cap_windows"] == r["sweeps"]
              and sweep["samples"] == n_chassis * r["sweeps"],
              f"{what}: a window of {n_chassis} samples per sweep: {sweep}")
        check(removed >= sweep["cut_watts"] - sweep["leftover_watts"]
              - 1e-3 * max(1.0, sweep["cut_watts"]),
              f"{what}: watts removed {removed} cover the demand past the "
              f"floors {sweep}")
        check(v("serve_arrivals_total") == len(batch)
              and obs.quality.n_scored == len(batch),
              f"{what}: every arrival counted and scored")
        rec = obs.recorder
        check(not rec.wrapped, f"{what}: the recorder holds the stream")
        t0 = time.perf_counter()
        got = verify_replay(rec, pipeline(1))
        replay_s = time.perf_counter() - t0
        check(np.array_equal(got, off["servers"]),
              f"{what}: the replay gives every recorded decision")
        trail = obs.adaptive
        out[f"hosts_{hosts}"] = {
            "arrivals_per_s": r["arrivals_per_s"],
            "sweep_counters": sweep, "watts_removed": removed,
            "alarms": r["alarms"], "replay_s": replay_s,
            "replayed_decisions": len(got),
            "adaptive_rows": trail.total_recorded,
            "adaptive_backoffs": len(trail.backoffs()),
            "adaptive_last": trail.explain(trail.total_recorded - 1)
            .describe() if trail.total_recorded else None,
            "slo_active": [a["slo"] for a in obs.slo.active_alerts()],
            "slo_alerts_total": {r_: int(s["alerts"]) for r_, s
                                 in obs.slo.summary().items()},
            "recorder": {k: rec.summary()[k] for k in (
                "rows", "runs", "by_kind", "dropped_runs")},
            "incidents": len(rec.incidents),
            "balloon_inflations": v("balloon_inflations_total"),
            "spans": {k: int(n) for k, (n, _) in obs.tracer.totals()
                      .items()}}
    return {"arrivals": len(batch), "sweeps": off["sweeps"],
            "alarms": off["alarms"], "launches": launches,
            "decisions_equal_obs_off": True, "replay_equal": True, **out}


def obs_sharded(run, hist, budget_w: float, cluster_w: float, dev) -> dict:
    """The serving cell at 4 shards under `sharded_serve`'s 80 % pool
    (`cluster_w`), obs on against obs off (timed off, on, on, off):
    bit-equal decisions and pools;
    then every other admitted VM departs from the obs pipeline, and the
    tokens it drew minus the tokens departures credited must be the
    pools' change (1e-4 relative), the spill counters the pipeline's
    `spill_info`. The launch counts read from 0 around the obs run."""
    import torch
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.obs import Observability
    from repro_torch.serve import (PlaneBundle, ResourceVector,
                                   ShardedServeConfig, ShardedServePipeline)

    def pipeline(obs):
        return ShardedServePipeline.from_history(
            run["svc"], hist, run["labels"], n_servers=N_SERVERS,
            cores_per_server=CORES, blades_per_chassis=BLADES, device=dev,
            config=ShardedServeConfig(
                batch_size=BATCH, n_shards=4, planes=PlaneBundle(
                    chassis_budget=ResourceVector(watts=budget_w),
                    cluster_budget=ResourceVector(watts=cluster_w),
                    obs=obs)))

    def serve_all(pipe):
        t0 = time.perf_counter()
        parts = [pipe.serve(chunk) for chunk in micro_batches(run["batch"])]
        torch.cuda.synchronize()
        return parts, time.perf_counter() - t0
    off = pipeline(None)
    parts_off, wall_off = serve_all(off)
    obs = Observability.full()
    on = pipeline(obs)
    pool_start = on._pool_tokens_left()
    reset_launches()
    parts, wall_on = serve_all(on)
    launches = dict(KERNEL_LAUNCHES)
    # a second pair, the other side first
    wall_on2 = serve_all(pipeline(Observability.full()))[1]
    wall_off2 = serve_all(pipeline(None))[1]
    walls = {"off": [wall_off, wall_off2], "on": [wall_on, wall_on2]}
    servers = np.concatenate([p.server for p in parts])
    check(np.array_equal(servers,
                         np.concatenate([p.server for p in parts_off])),
          "obs_sharded: obs on decides as obs off")
    check(torch.equal(on.sharded.pool, off.sharded.pool),
          "obs_sharded: pools bit-equal with obs on and off")
    check((servers == -3).sum() > 0, "obs_sharded: the pools run out")
    adm = np.flatnonzero(servers >= 0)[::2]
    p95 = np.concatenate([p.p95_eff for p in parts])
    uf = np.concatenate([p.workload_type for p in parts]) == 1
    on.depart(servers[adm], run["batch"].cores[adm], p95[adm], uf[adm],
              mem_gb=run["batch"].memory_gb[adm])
    pool_end = on._pool_tokens_left()
    v = obs.registry.value
    drawn = v("serve_tokens_drawn_total")
    credited = v("serve_tokens_credited_total")
    change = pool_start - pool_end
    check(abs((drawn - credited) - change) <= 1e-4 * abs(change),
          f"obs_sharded: drawn {drawn} - credited {credited} == the pools' "
          f"change {change}")
    info = on.spill_info
    spill = {"rounds": v("serve_spill_rounds_total"),
             "spilled": v("serve_spilled_total"),
             "spill_admitted": v("serve_spill_admits_total")}
    n_batches = N_ARRIVALS // BATCH
    check(spill["spilled"] == info["spilled"]
          and spill["spill_admitted"] == info["spill_admitted"]
          and spill["rounds"] == info["rounds"] - n_batches
          and v("serve_dispatch_total", kind="sharded_round")
          == info["rounds"],
          f"obs_sharded: spill counters {spill} match {info}")
    check(launches["forest"] == n_batches,
          f"obs_sharded: a forest launch per micro-batch: {launches}")
    return {"shards": 4, "cluster_budget_w": cluster_w,
            "admitted": int((servers >= 0).sum()),
            "token_rejected": int((servers == -3).sum()),
            "pool_start": pool_start, "pool_end": pool_end,
            "tokens_drawn": drawn, "tokens_credited": credited,
            "departed": len(adm), "spill_counters": spill,
            "spill_info": info, "launches": launches,
            "arrivals_per_s": {k: [N_ARRIVALS / w for w in v]
                               for k, v in walls.items()},
            "overhead_share": sum(walls["on"]) / sum(walls["off"]) - 1.0,
            "decisions_equal_obs_off": True, "tokens_conserved": True}


def monitor_phase(dev) -> dict:
    """`python -m repro_torch.launch.monitor --sim` on `dev` at
    MONITOR_SHARDS shards over MONITOR_DAYS days,
    writing its snapshot, Prometheus text and alerts under
    build/obs_monitor/: the snapshot must parse back to the bundle's, the
    Prometheus text hold MONITOR_FAMILIES, the alerts their schema. The
    launch counts read from 0 around it."""
    import contextlib
    import io
    import torch
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.launch import monitor
    out_dir = Path(__file__).resolve().parent / "build" / "obs_monitor"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {k: str(out_dir / f) for k, f in (
        ("out", "obs_snapshot.json"), ("prom", "metrics.prom"),
        ("alerts", "obs_alerts.json"))}
    report = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(report):
        obs = monitor.main(["--sim", "--device", str(dev),
                            "--shards", str(MONITOR_SHARDS),
                            "--days", str(MONITOR_DAYS),
                            *(x for k, p in paths.items()
                              for x in (f"--{k}", p))])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(KERNEL_LAUNCHES)
    with open(paths["out"]) as f:
        snap = json.load(f)
    check(snap == json.loads(json.dumps(monitor.snapshot_dict(obs))),
          "monitor: the snapshot parses back to the bundle's")
    with open(paths["prom"]) as f:
        prom = f.read()
    check(prom == obs.registry.to_prometheus(),
          "monitor: the Prometheus text is the registry's")
    missing = [k for k in MONITOR_FAMILIES if k not in prom]
    check(not missing, f"monitor: Prometheus families missing: {missing}")
    with open(paths["alerts"]) as f:
        alerts = json.load(f)
    check(set(alerts) == {"active", "rules"}
          and all(alerts["rules"][a["slo"]]["active"]
                  for a in alerts["active"]),
          "monitor: the alerts artifact's schema")
    v = obs.registry.value
    check(v("sim_placements_total") > 0
          and v("serve_dispatch_total", kind="sharded_round") > 0,
          "monitor: the sim placed through the sharded rounds")
    text = report.getvalue()
    return {"shards": MONITOR_SHARDS, "days": MONITOR_DAYS,
            "seconds": seconds, "report_lines": len(text.splitlines()),
            "sections": [ln for ln in text.splitlines()
                         if ln.startswith("== ")],
            "placements": v("sim_placements_total"),
            "failures": v("sim_failures_total"),
            "alarms": v("emergency_alarms_total"),
            "migrations": v("emergency_migrations_total"),
            "throttled_s": {lv: v("emergency_throttled_seconds_total",
                                  level=lv) for lv in ("nuf", "uf")},
            "sharded_rounds": v("serve_dispatch_total",
                                kind="sharded_round"),
            "scored": obs.quality.n_scored,
            "active_alerts": [a["slo"] for a in alerts["active"]],
            "families": list(MONITOR_FAMILIES),
            "snapshot_bytes": os.path.getsize(paths["out"]),
            "prom_lines": len(prom.splitlines()), "launches": launches}


def train_flops(cfg, b: int, s: int) -> float:
    """Model FLOPs of one train step with remat and the naive attention:
    6 N T for the matmul weights (N: the parameters less the embedding
    table), the remat's second forward of the blocks (2 N_blocks T), the
    CE chunks' recomputed head (2 d V T), and the attention products
    (QK^T and PV, 4 B H S^2 hd a layer forward over the full square),
    four times over (forward, recompute, and the backward's four)."""
    t = b * s
    n_mm = cfg.param_count() - cfg.vocab_size * cfg.d_model
    head = cfg.d_model * cfg.vocab_size
    attn = 4 * b * cfg.n_heads * s * s * cfg.head_dim * cfg.n_layers
    return 6 * n_mm * t + 2 * (n_mm - head) * t + 2 * head * t + 4 * attn


def _free() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _token_batch(cfg, b: int, s: int, seed: int, dev) -> dict:
    import torch
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                               device=dev) for k in ("tokens", "labels")}


def train_card_vs_cpu(seed: int, dev) -> dict:
    """Reduced phi4-mini in float32, the same weights and batch: the
    gradients and one `make_train_step` on the card against the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import get_optimizer
    from repro_torch.tree import leaves, tree_map
    cfg = get_config(TRAIN_ARCH).reduced()
    cpu = torch.device("cpu")
    params = T.init_params(cfg, seed, dtype=torch.float32, device=cpu)
    state = get_optimizer(cfg.optimizer).init(params)
    batch = _token_batch(cfg, 4, 64, seed, cpu)
    on_dev = lambda tree: tree_map(lambda t: t.to(dev), tree)  # noqa: E731
    l_cpu, g_cpu = loss_and_grads(cfg, params, batch)
    l_dev, g_dev = loss_and_grads(cfg, on_dev(params), on_dev(batch))
    grad_gap = max(float((a.cpu() - b).abs().max() / b.abs().max())
                   for a, b in zip(leaves(g_dev), leaves(g_cpu)))
    _, _, m_cpu = make_train_step(cfg)(params, state, batch)
    _, _, m_dev = make_train_step(cfg)(on_dev(params), on_dev(state),
                                       on_dev(batch))
    out = {"config": f"{cfg.name} reduced, float32, batch 4 x 64",
           "loss_card": float(l_dev), "loss_cpu": float(l_cpu),
           "loss_rel_gap": abs(float(l_dev) / float(l_cpu) - 1),
           "step_loss_rel_gap": abs(float(m_dev["loss"])
                                    / float(m_cpu["loss"]) - 1),
           "grad_norm_rel_gap": abs(float(m_dev["grad_norm"])
                                    / float(m_cpu["grad_norm"]) - 1),
           "max_grad_gap_over_leaf_max": grad_gap}
    check(out["loss_rel_gap"] <= TRAIN_LOSS_RTOL
          and out["step_loss_rel_gap"] <= TRAIN_LOSS_RTOL,
          f"train loss on the card within {TRAIN_LOSS_RTOL} of the CPU: {out}")
    check(out["grad_norm_rel_gap"] <= TRAIN_GNORM_RTOL,
          f"grad norm on the card within {TRAIN_GNORM_RTOL} of the CPU: {out}")
    check(grad_gap <= TRAIN_GRAD_REL_ATOL,
          f"every gradient leaf on the card within {TRAIN_GRAD_REL_ATOL} of "
          f"its largest |g| on the CPU: {grad_gap}")
    return out


def train_determinism(seed: int, dev) -> dict:
    """Two train steps from one state on the card, bit for bit: reduced
    phi4-mini (8 x 512 tokens: the embedding's sorted backward), mixtral
    (8,192 assignments: the capacity drops some) and zamba2 (the SSD's
    chunked scan), bf16, impl 'naive' as `launch.train` runs. Then once
    more under `torch.use_deterministic_algorithms(True, warn_only=True)`,
    recording what PyTorch flags (nothing is checked on that)."""
    import warnings

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import get_optimizer
    from repro_torch.tree import leaves
    out, runs = {}, []
    for arch in (TRAIN_ARCH, "mixtral-8x22b", "zamba2-2.7b"):
        cfg = get_config(arch).reduced()
        params = T.init_params(cfg, seed, device=dev)
        state = get_optimizer(cfg.optimizer).init(params)
        batch = _token_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed, dev)
        step = make_train_step(cfg, impl="naive")
        a, b = (leaves(step(params, state, batch)) for _ in range(2))
        diff = max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(a, b))
        out[arch] = {"bit_equal": all(torch.equal(x, y)
                                      for x, y in zip(a, b)),
                     "max_abs_diff": diff}
        runs.append((step, params, state, batch))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for step, params, state, batch in runs:
                step(params, state, batch)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    out["flagged_by_torch"] = sorted({str(w.message).splitlines()[0][:200]
                                      for w in caught})
    check(all(out[a]["bit_equal"] for a in out if a != "flagged_by_torch"),
          f"two train steps from one state are bit-equal on the card: {out}")
    return out


def train_full_width(seed: int, dev, ckpt_dir: Path) -> dict:
    """`launch.train.main` on phi4-mini-3.8b at full width, AdamW, 8 x 512
    tokens, TRAIN_STEPS steps (no checkpoint): ms a step, tokens/s, model
    TFLOP/s, peak memory, the host snapshot, and one profiled step. The
    hand-written kernels must not launch: training runs the plain paths,
    as the reference's does."""
    import contextlib
    import io

    import torch
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    cfg = get_config(TRAIN_ARCH)
    trace, printed = {}, io.StringIO()
    _free()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        losses = train.main(
            ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
             str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--ckpt-every",
             str(10 * TRAIN_STEPS), "--ckpt-dir", str(ckpt_dir), "--seed",
             str(seed), "--device", str(dev)], trace=trace)
    wall = time.perf_counter() - t0
    launches = dict(KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    loop, hist = trace["loop"], trace["history"]
    step_ms = [t * 1e3 for t in loop.state.step_times]
    ms = statistics.median(step_ms[1:])
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "reduced": None,
           "params": cfg.param_count(), "optimizer": cfg.optimizer,
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "steps": len(losses),
           "wall_s": wall, "step_ms": step_ms, "ms_per_step": ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
           "model_tflop_per_step": flops / 1e12,
           "model_tflops": flops / ms / 1e9,
           "model_flops_share_of_bf16_peak": flops / ms * 1e3
           / BF16_OPS_PER_S,
           "peak_memory_gb": peak / 1e9,
           "snapshot_s": loop.state.snapshot_s,
           "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
           "kernel_launches": launches,
           "printed": printed.getvalue().splitlines()}
    check(all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]),
          f"full-width losses and grad norms finite: {out['losses']}")
    check(sum(launches.values()) == 0,
          f"training launches no hand-written kernel: {launches}")
    state, step_fn = [trace.pop("state")], trace["step_fn"]
    batch = (TRAIN_STEPS, trace["source"].batch_at(TRAIN_STEPS))

    def one_step():
        state[0], _ = step_fn(state[0], batch)
    out["step_profile"] = device_profile(one_step)
    del state, trace, step_fn
    _free()
    return out


def train_variants(seed: int, dev) -> dict:
    """phi4-mini at TRAIN_CMP_LAYERS layers, 8 x 512, bf16, three steps
    each from one seeded state: remat on (the default), remat off, and 2
    micro-batches with remat; ms (median of steps 2 and 3), peak memory,
    the metrics of every step."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import get_optimizer
    base = dataclasses.replace(get_config(TRAIN_ARCH),
                               n_layers=TRAIN_CMP_LAYERS)
    batch = _token_batch(base, TRAIN_BATCH, TRAIN_SEQ, seed, dev)
    out = {"reduced": f"n_layers {get_config(TRAIN_ARCH).n_layers} -> "
                      f"{TRAIN_CMP_LAYERS}"}
    for name, cfg, micro in (
            ("remat", base, 1),
            ("no_remat", dataclasses.replace(base, remat=False), 1),
            ("micro_2", base, 2)):
        params = T.init_params(cfg, seed, device=dev)
        state = get_optimizer(cfg.optimizer).init(params)
        step = make_train_step(cfg, impl="naive", microbatches=micro,
                               donate=True)
        _free()
        torch.cuda.reset_peak_memory_stats()
        times, metrics = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"ms": statistics.median(times[1:]), "step_ms": times,
                     "peak_memory_gb": torch.cuda.max_memory_allocated()
                     / 1e9, "metrics": metrics}
        del params, state
        _free()
    r, n, m2 = out["remat"], out["no_remat"], out["micro_2"]
    out["remat_bit_equal_metrics"] = r["metrics"] == n["metrics"]
    out["micro_2_loss_rel_gap"] = abs(m2["metrics"][0]["loss"]
                                      / r["metrics"][0]["loss"] - 1)
    out["micro_2_grad_norm_rel_gap"] = abs(
        m2["metrics"][0]["grad_norm"] / r["metrics"][0]["grad_norm"] - 1)
    check(out["remat_bit_equal_metrics"],
          f"remat on and off give the same losses and grad norms: {out}")
    check(out["micro_2_grad_norm_rel_gap"] <= TRAIN_MICRO_GNORM_RTOL,
          f"2 micro-batches' grad norm within {TRAIN_MICRO_GNORM_RTOL} of "
          f"1's: {out['micro_2_grad_norm_rel_gap']}")
    return out


def train_vlm(seed: int, dev) -> dict:
    """qwen2-vl-72b cut to VLM_TRAIN_LAYERS layers with its Adafactor, 8 x
    512 tokens of which the first N_PATCHES positions take seeded patch
    embeddings: three steps, ms (median of steps 2 and 3), peak memory,
    losses finite."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import get_optimizer
    full = get_config("qwen2-vl-72b")
    cfg = dataclasses.replace(full, n_layers=VLM_TRAIN_LAYERS)
    _free()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, seed, device=dev)
    state = get_optimizer(cfg.optimizer).init(params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = _token_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed, dev)
    batch["patch_embeds"] = (torch.randn(
        (TRAIN_BATCH, N_PATCHES, cfg.d_model), generator=gen, device=dev)
        * 0.02).bfloat16()
    step = make_train_step(cfg, impl="naive", donate=True)
    times, metrics = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "reduced": f"n_layers {full.n_layers} -> {VLM_TRAIN_LAYERS}",
           "params": sum(t.numel() for t in _tensors(params)),
           "optimizer": cfg.optimizer, "patches": N_PATCHES,
           "ms": statistics.median(times[1:]), "step_ms": times,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "metrics": metrics}
    check(all(math.isfinite(v) for m in metrics for v in m.values()),
          f"qwen2-vl train metrics finite: {metrics}")
    del params, state, batch
    _free()
    return out


def train_fault_tolerance(dev, root: Path) -> dict:
    """The train_lm twin's demo-20m for FT_STEPS steps on the card, with
    failures injected at FT_RATE and checkpoints every FT_EVERY steps,
    against the same run without failures: at least one restart and the
    same final state; and its newest checkpoint, written from the card,
    restored on the CPU equals that state."""
    import contextlib
    import io
    import shutil

    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.examples import train_lm
    from repro_torch.tree import leaves, tree_map
    shutil.rmtree(root, ignore_errors=True)
    args = ["--steps", str(FT_STEPS), "--ckpt-every", str(FT_EVERY),
            "--device", str(dev)]
    clean, failed = {}, {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train_lm.main(args + ["--ckpt-dir", str(root / "clean")],
                      trace=clean)
        t_clean = time.perf_counter() - t0
        losses = train_lm.main(args + ["--ckpt-dir", str(root / "failed"),
                                       "--inject-failures", str(FT_RATE)],
                               trace=failed)
    a, b = leaves(clean["state"]), leaves(failed["state"])
    ck = Checkpointer(str(root / "failed"))
    cpu_like = tree_map(lambda t: t.cpu(), failed["state"])
    restored, step = ck.restore(cpu_like)
    out = {"config": "demo-20m", "steps": FT_STEPS, "rate": FT_RATE,
           "ckpt_every": FT_EVERY,
           "restarts": failed["loop"].state.restarts,
           "steps_taken": len(losses), "clean_s": t_clean,
           "failed_s": time.perf_counter() - t0 - t_clean,
           "final_state_bit_equal": all(torch.equal(x, y)
                                        for x, y in zip(a, b)),
           "max_abs_diff": max(float((x.float() - y.float()).abs().max())
                               for x, y in zip(a, b)),
           "checkpoint_step": step,
           "checkpoint_restores_on_cpu": all(
               x.device.type == "cpu" and torch.equal(x, y)
               for x, y in zip(leaves(restored), leaves(cpu_like)))}
    check(out["restarts"] >= 1, f"failures were injected: {out}")
    check(out["final_state_bit_equal"],
          f"the run with failures ends in the clean run's state: {out}")
    check(step == FT_STEPS and out["checkpoint_restores_on_cpu"],
          f"the card's checkpoint restores on the CPU: {out}")
    del clean, failed, restored, cpu_like
    shutil.rmtree(root, ignore_errors=True)
    _free()
    return out


def lm_train(seed: int, dev) -> dict:
    """The LM training path on the card, each part's line emitted as it
    ends: the card against the CPU, determinism, phi4-mini at full width
    through `launch.train`, the remat and micro-batch variants, qwen2-vl
    with Adafactor, and the fault-tolerant replay."""
    root = Path(__file__).resolve().parent / "build" / "lm_train"
    out = {}
    for name, fn in (
            ("card_vs_cpu", lambda: train_card_vs_cpu(seed, dev)),
            ("determinism", lambda: train_determinism(seed, dev)),
            ("full_width", lambda: train_full_width(seed, dev,
                                                    root / "full_width")),
            ("variants", lambda: train_variants(seed, dev)),
            ("vlm_adafactor", lambda: train_vlm(seed, dev)),
            ("fault_tolerance", lambda: train_fault_tolerance(
                dev, root / "fault_tolerance"))):
        out[name] = fn()
        emit(f"lm_train_{name}", **out[name])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.core import criticality
    from repro_torch.core import features as F
    from repro_torch.core.power_model import ServerPowerModel
    from repro_torch.core.predictor import bucket_to_p95
    from repro_torch.kernels import build
    from repro_torch.kernels.forest import ops as forest_ops
    from repro_torch.kernels.forest import ref as forest_ref
    from repro_torch.serve import (FAIL_CAPACITY, FAIL_POWER, ServePipeline,
                                   featurize_batch, fresh_state)
    from repro_torch.serve.featurizer import SubscriptionTable
    from repro_torch.sim.telemetry import arrival_batch, generate_population

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], allow_tf32_matmul=False,
         allow_tf32_cudnn=False)

    # 2. build
    info = build.build()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln]
    mma = sass_mma_counts(info["path"])
    # flash runs on Hopper's own path: warpgroup MMAs fed by TMA
    got = {k: v for k, v in mma.items() if "flash_kernel_bf16" in k}
    check(got and all(v["HGMMA"] > 0 and v["UTMALDG"] > 0
                      for v in got.values()),
          f"every flash_kernel_bf16 instantiation has HGMMA and UTMALDG "
          f"instructions: {got}")
    got = {k: v for k, v in mma.items() if "ssd_kernel_bf16" in k}
    check(got and all(v["HGMMA"] > 0 and v["UTMALDG"] > 0
                      for v in got.values()),
          f"every ssd_kernel_bf16 instantiation has HGMMA and UTMALDG "
          f"instructions: {got}")
    emit("build", seconds=info["seconds"], library=info["path"],
         ptxas=ptxas, sass_mma_counts=mma)

    # host data for every later phase
    t0 = time.perf_counter()
    pop = generate_population(N_VMS, seed=args.seed)
    hist, rest = F.split_history_arrivals(pop)
    arrivals = type(rest)(vms=rest.vms[:N_ARRIVALS])
    emit("population", vms=N_VMS, history=len(hist.vms),
         arrivals=len(arrivals.vms), seconds=time.perf_counter() - t0)

    # 3. template kernel against its plain version: the fleet labeling
    #    pass, the main path's history, and the 200-VM seed-9 bar
    res_fleet = template_phase(fleet_series(pop, FLEET_ROWS, args.seed),
                               dev)
    check(res_fleet["label_agreement"] >= 0.999, "fleet label agreement")
    emit("template_fleet", **res_fleet)
    res_hist = template_phase(hist.series, dev)
    emit("template_history", **res_hist)
    res9 = template_phase(generate_population(200, seed=9).series, dev,
                          timed=False)
    check(res9["label_agreement"] == 1.0, "seed-9 labels agree exactly")
    emit("template_seed9", **res9)
    #    the block path: a day's labeling batch at 30 and 90 days of history
    res_long = {}
    for t in TEMPLATE_LONG_T:
        res_long[t] = template_phase(
            fleet_series(pop, TEMPLATE_LONG_ROWS, args.seed + t, t), dev)
        check(res_long[t]["label_agreement"] == 1.0,
              f"labels equal at T {t}")
        emit(f"template_long_{t}", **res_long[t])
    from repro_torch.kernels.template import ops as template_ops
    block_smem = template_ops.block_static_smem()
    check(block_smem <= template_ops.BLOCK_STATIC_SMEM,
          f"the block kernel's static shared memory ({block_smem} bytes) "
          f"within the {template_ops.BLOCK_STATIC_SMEM} that MAX_T_BLOCK "
          "leaves it")

    # 5. the main path, with every launch count at 0 just before it
    #    budget: each chassis may commit its share of the rho the
    #    arrivals would commit at their true P95 buckets; conservative
    #    predictions commit more, so some arrivals hit FAIL_POWER
    true_rho = float(np.dot(
        [v.cores for v in arrivals.vms],
        bucket_to_p95(F.p95_bucket([v.p95_util for v in arrivals.vms]))))
    rho_cap = true_rho / (N_SERVERS // BLADES)
    model = ServerPowerModel()
    budget_w = BLADES * model.p_idle + rho_cap * model.p_dyn_per_core
    reset_launches()
    run = main_path(pop, hist, arrivals, budget_w, dev)
    launches = dict(KERNEL_LAUNCHES)
    pipe, parts = run["pipe"], run["parts"]
    main_state = pipe.state     # the main path's final state, for 1 shard
    servers = np.concatenate([p.server for p in parts])
    n_batches = len(parts)
    admitted = int((servers >= 0).sum())
    cap_rej = int((servers == FAIL_CAPACITY).sum())
    pow_rej = int((servers == FAIL_POWER).sum())
    conservative = int(sum(p.n_conservative for p in parts))
    bm = sorted(run["batch_ms"])
    emit("main_path", servers=N_SERVERS, chassis=N_SERVERS // BLADES,
         cores_per_server=CORES, history=len(hist.vms),
         arrivals=len(servers), batch=BATCH, budget_w_per_chassis=budget_w,
         uf_labeled=float(run["labels"].mean()),
         label_truth_agreement=float((run["labels"] == hist.labels).mean()),
         label_s=run["t_label"], train_s=run["t_train"],
         serve_s=run["t_serve"], admitted=admitted,
         capacity_rejected=cap_rej, power_rejected=pow_rej,
         conservative=conservative,
         arrivals_per_s=len(servers) / run["t_serve"],
         batch_p50_ms=float(np.percentile(bm, 50)),
         batch_p99_ms=float(np.percentile(bm, 99)), launches=launches)

    # 6. main-path checks
    check(admitted + cap_rej + pow_rej == N_ARRIVALS,
          "admitted + capacity + power rejects == arrivals")
    check(pow_rej > 0, "the chassis budget rejected some arrivals")
    check(bool((pipe.state.free_cores >= 0).all()), "free cores >= 0")
    check(bool((pipe.state.rho_peak <= pipe.rho_cap).all()),
          "every chassis rho_peak <= rho_cap")
    check(launches["forest"] == n_batches,
          f"forest launches {launches['forest']} == batches {n_batches}")
    check(launches["template"] >= 1, "template kernel launched")
    labels_cpu = criticality.classify(hist.series, device="cpu").numpy()
    label_agree = float((labels_cpu == run["labels"]).mean())
    cpu_pipe = ServePipeline(
        run["svc"], SubscriptionTable(*(a.cpu() for a in pipe.table)),
        fresh_state(N_SERVERS, CORES, np.arange(N_SERVERS) // BLADES,
                    device="cpu"), CORES, config=run["config"],
        blades_per_chassis=BLADES)
    t0 = time.perf_counter()
    cpu_res = cpu_pipe.serve(run["batch"])
    cpu_s = time.perf_counter() - t0
    for f in ("server", "workload_type", "p95_bucket", "conservative",
              "p95_eff"):
        check(np.array_equal(getattr(cpu_res, f),
                             np.concatenate([getattr(p, f) for p in parts])),
              f"CPU serve gives identical {f}")
    emit("main_path_checks", outcomes_sum=True, free_cores_nonneg=True,
         rho_within_cap=True, forest_launches_eq_batches=True,
         cpu_servers_identical=True, cpu_serve_s=cpu_s,
         history_labels_cpu_agreement=label_agree)
    emit("featurizer_determinism",
         **featurizer_determinism(run, hist, parts, dev))

    # 4. forest kernel against its plain version, on the four-forest stack
    #    the main path trained (so it runs after the main path)
    stacked = pipe._buffers[pipe._active][0].stacked
    check(stacked is not None, "the four forests ran as one stack")
    nf, t, d = stacked.feat_idx.shape
    k = stacked.leaf.shape[-1]
    x_all = featurize_batch(pipe.table, run["batch"])
    x_mb = x_all[:BATCH].contiguous()
    rows = np.random.default_rng(args.seed).integers(0, len(x_all),
                                                     FLEET_ROWS)
    x_big = x_all[torch.as_tensor(rows, device=dev)].contiguous()
    forest = {}
    for name, x, svc in (("micro_batch", x_mb, run["svc"]),
                         ("batch_scoring", x_big, None)):
        r = forest_phase(x, stacked, svc)
        r["ms"] = cuda_ms(lambda: forest_ops.forest_sums(x, *stacked))
        r["plain_ms"] = cuda_ms(
            lambda: forest_ref.forest_sums_ref(x, *stacked))
        r["bound_ms"], r["bound_by"] = forest_bound_ms(
            x.shape[0], x.shape[1], nf, t, d, k)
        kernel_times(r, lambda: forest_ops.forest_sums(x, *stacked),
                     "forest_sums_kernel")
        # the call `served_query` makes: the stack was checked when packed
        r["host_us_served"] = host_us(
            lambda: forest_ops.forest_sums(x, *stacked, checked=True))
        emit(f"forest_{name}", **r)
        forest[name] = r

    edges = placement_edge_sweep(pop, args.seed, dev)
    emit("placement_edge_sweep", **edges)

    # where a served micro-batch's time goes, on two batches after the
    # main path (their launches come after the counts were read)
    nxt = rest.vms[N_ARRIVALS:N_ARRIVALS + 2 * BATCH]
    extra = (arrival_batch(type(rest)(vms=nxt[:BATCH])),
             arrival_batch(type(rest)(vms=nxt[BATCH:])))
    emit("serve_profile", **serve_profile(pipe, *extra))

    # flash and SSD kernels against their plain versions: at the LM
    # path's prefill shapes and at one long prompt
    flash = {"prefill": flash_phase(LM_BATCH, LM_PROMPT, args.seed, dev),
             "long": flash_phase(1, LONG_PROMPT, args.seed + 1, dev)}
    ssd = {"prefill": ssd_phase(LM_BATCH, LM_PROMPT, args.seed, dev, True),
           "long": ssd_phase(1, LONG_PROMPT, args.seed + 1, dev, False)}
    for name in ("prefill", "long"):
        emit(f"flash_attention_{name}", **flash[name])
        emit(f"ssd_{name}", **ssd[name])
    emit("bf16_edge_sweep", **edge_sweep(args.seed, dev))
    gaps = flash_gaps(args.seed, dev)
    for name, res in gaps.items():
        emit(f"flash_attention_{name}", **res)
    ssd_wide = ssd_widths(args.seed, dev)
    for name, res in ssd_wide.items():
        emit(f"ssd_{name}", **res)

    # the LM serving path: prefill through the kernels, serve_batch
    # through the cache path, each read from counts at 0
    lm = lm_path(args.seed, dev)
    emit("lm_serve", **lm)
    # the moe, audio and vlm families, one model at a time (each line
    # emitted inside, its counts read from 0), and the flash kernel at
    # mixtral's head shape
    families = lm_families(args.seed, dev)
    emit("flash_attention_mixtral", **families["flash_mixtral"])

    # the evaluation path: the fleet engine (Figs 4-6, Table IV) and the
    # Fig 7 scheduler simulation, read from counts at 0 (it runs no
    # hand-written kernel: the fleet step and placement are torch ops)
    reset_launches()
    emit("fleet_parity", **fleet_parity(dev))
    emit("fleet_scale", **fleet_scale(dev))
    emit("table4_sweep", **table4_sweep(dev))
    emit("scheduler_sim", **scheduler_sim(dev))
    emit("eval_path", launches=dict(KERNEL_LAUNCHES))

    # the streamed serving loop with the power-emergency plane (its counts
    # read from 0 inside: labeling plus the first streamed run), then the
    # emergency plane in the scheduler simulation, read from counts at 0
    stream = streamed_serve(run, hist, arrivals, budget_w, args.seed, dev)
    stream_labels = stream.pop("labels")
    emit("streamed_serve", **stream)
    reset_launches()
    emit("sim_emergency", **sim_emergency(dev),
         launches=dict(KERNEL_LAUNCHES))

    # the example twins (counts read from 0 inside, per twin); the
    # streamed cell with the ballooning rung and the adaptive controller
    # (counts read from 0 inside: the 1-host run with both planes); the
    # ladder and adaptive arms of the simulation, read from counts at 0
    examples = examples_phase(dev)
    emit("examples", **examples)
    planes = streamed_planes(run, hist, arrivals, stream_labels, budget_w,
                             args.seed, stream, dev)
    emit("streamed_planes", **planes)
    reset_launches()
    arms = sim_arms(dev)
    for name, res in arms.items():
        emit(name, **res, launches=dict(KERNEL_LAUNCHES))

    # sharded serving: the serving cell at 1, 2 and 4 shards and under a
    # cluster budget (each card run read from counts at 0 inside); the
    # streamed cell with both planes at 4 shards (its counts read from 0
    # inside); the Fig 7 simulation on the serve-sharded backend, read
    # from counts at 0
    shard_serve = sharded_serve(run, hist, budget_w, servers, main_state,
                                extra, dev)
    emit("sharded_serve", **shard_serve)
    shard_planes = sharded_planes(run, hist, arrivals, stream_labels,
                                  budget_w, args.seed, dev)
    emit("sharded_planes", **shard_planes)
    # the mesh leg: one shard a position of a mesh over the card repeated
    # (each served run's counts read from 0 inside)
    shard_mesh_out = sharded_mesh(run, hist, arrivals, stream_labels,
                                  budget_w, shard_serve, shard_planes, extra,
                                  args.seed, dev)
    emit("sharded_mesh", **shard_mesh_out)
    reset_launches()
    emit("sim_sharded", **sim_sharded(dev), launches=dict(KERNEL_LAUNCHES))

    # the observability plane: the serving cell, the streamed cell with
    # both planes and the 4-shard pooled cell with `Observability.full()`
    # against obs off, and the monitor CLI's sim (each obs run's counts
    # read from 0 inside)
    o_serve = obs_serve(run, hist, budget_w, servers, main_state,
                        conservative, extra, args.seed, dev)
    emit("obs_serve", **o_serve)
    o_stream = obs_streamed(run, hist, arrivals, stream_labels, budget_w,
                            args.seed, dev)
    emit("obs_streamed", **o_stream)
    o_shard = obs_sharded(run, hist, budget_w,
                          shard_serve["shards_4_budget"]["cluster_budget_w"],
                          dev)
    emit("obs_sharded", **o_shard)
    o_mon = monitor_phase(dev)
    emit("monitor", **o_mon)

    # LM training: the card against the CPU, determinism, phi4-mini at
    # full width through launch.train (its counts read from 0 inside, all
    # four must stay 0), the remat and micro-batch variants, qwen2-vl with
    # Adafactor and the fault-tolerant replay, each line emitted inside
    train = lm_train(args.seed, dev)
    train_launches = train["full_width"]["kernel_launches"]

    # the mesh layer: the fsdp2d step on a one-rank NCCL mesh against the
    # plain step, the dry-run's cells on the production meshes, and the
    # multi-card step where there is more than one card
    mesh = mesh_phase(args.seed, dev)
    obs_launches = {name: {k: r["launches"][k]
                           for k in ("forest", "template")}
                    for name, r in (("obs_serve", o_serve),
                                    ("obs_streamed", o_stream),
                                    ("obs_sharded", o_shard),
                                    ("monitor", o_mon))}

    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "forest_sums", "route": "cuda",
         "source": "src/repro_torch/csrc/forest.cu",
         "replaces": "src/repro/kernels/forest/forest.py:95",
         "launches": launches["forest"],
         "launches_streamed": stream["launches"]["forest"],
         "launches_examples": examples["quickstart"]["launches"]["forest"],
         "launches_streamed_planes": planes["launches"]["forest"],
         "launches_sharded_serve": {
             k: v["launches"]["forest"] for k, v in shard_serve.items()
             if isinstance(v, dict) and "launches" in v},
         "launches_sharded_planes": shard_planes["launches"]["forest"],
         "launches_sharded_mesh": {
             k: v["launches"]["forest"] for k, v in shard_mesh_out.items()
             if isinstance(v, dict) and "launches" in v},
         "launches_sharded_mesh_planes": {
             k: v["launches"]["forest"]
             for k, v in shard_mesh_out["planes"].items()},
         "launches_obs": {k: v["forest"] for k, v in obs_launches.items()},
         "launches_lm_train": train_launches["forest"],
         "launches_mesh": mesh["step"]["kernel_launches"]["forest"],
         **{k: forest["micro_batch"][k] for k in TIMES},
         "library_ms": None, "shape": forest["micro_batch"]["shape"],
         "blocks": forest["micro_batch"]["blocks"],
         "host_us_served": forest["micro_batch"]["host_us_served"],
         "edge_cases": [r["case"] for r in edges["forest"]],
         "edge_max_abs_err_per_tree": max(
             r["max_abs_err_per_tree"] for r in edges["forest"]),
         "batch_scoring": forest["batch_scoring"]},
        {"name": "criticality_scores", "route": "cuda",
         "source": "src/repro_torch/csrc/template.cu",
         "replaces": "src/repro/kernels/template/template.py:118",
         "launches": launches["template"],
         "launches_streamed": stream["launches"]["template"],
         "launches_examples": {
             k: examples[k]["launches"]["template"]
             for k in ("quickstart", "datacenter_sim")},
         "launches_obs": {k: v["template"] for k, v in obs_launches.items()},
         "launches_lm_train": train_launches["template"],
         "launches_mesh": mesh["step"]["kernel_launches"]["template"],
         **{k: res_hist[k] for k in TIMES},
         "library_ms": None, "shape": res_hist["shape"],
         "edge_shapes": [r["shape"] for r in edges["template"]],
         "edge_max_rel_err": max(r["max_rel_err"]
                                 for r in edges["template"]),
         "fleet": res_fleet,
         **{f"long_{t}": res_long[t] for t in TEMPLATE_LONG_T},
         "block_static_smem": block_smem,
         "max_t_block": template_ops.MAX_T_BLOCK},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:73",
         "launches": lm["prefill_launches"]["flash_attention"],
         "launches_lm_families": {
             arch: families[arch]["prefill_launches"]["flash_attention"]
             for arch, *_ in FAMILY_RUNS},
         "launches_lm_train": train_launches["flash_attention"],
         "launches_mesh": mesh["step"]["kernel_launches"]["flash_attention"],
         **{k: flash["prefill"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "shape", "tflops", "bound_share", "device_ms",
             "library_device_ms")},
         "long": flash["long"], "mixtral": families["flash_mixtral"],
         **gaps},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd.cu",
         "replaces": "src/repro/kernels/ssd/ssd.py:77",
         "launches": lm["prefill_launches"]["ssd"],
         "launches_lm_train": train_launches["ssd"],
         "launches_mesh": mesh["step"]["kernel_launches"]["ssd"],
         **{k: ssd["prefill"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "shape", "tflops", "bound_share", "device_ms")},
         "library_ms": None, "long": ssd["long"], **ssd_wide},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
