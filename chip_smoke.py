#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

It builds the port's four CUDA kernels from `src/repro_torch/csrc`
(printing ptxas's registers and spills, and the tensor-core instructions
in each kernel's SASS: every bf16 flash and SSD instantiation must have
HMMA/HGMMA), holds each kernel against its plain torch version on the
card, at the paths' shapes and at each kernel's edge shapes (forest:
one row, ragged batches, stacks over 48 KB of tables, depths 1, 8 and
12, K 1, 4 and 10; template: T 48 to 1,008, constant, zero and tied
rows; flash and SSD in bf16), and drives the port's two paths:

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
  and SSD kernels, then `serve_batch` on the same prompts with 32
  generated tokens through the cache path. It checks the launch counts
  (9 flash, 54 SSD per prefill), finite logits, prefill against the
  cache path, and the kernel forward against the plain forward;
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
- the two example twins on the card (`examples`): the quickstart through
  the template and forest kernels, the datacenter scenario through the
  template kernel and the torch fleet engine, their numbers printed;
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
  for the adaptive arm cut to SIM_ADAPTIVE's 0.5 days).

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

#: LM path: Zamba2-2.7B, 8 prompts of 512 tokens, 32 generated; the long
#: prompt of the kernel phases.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "zamba2-2.7b", 8, 512, 32
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
#: the whole script near 500 s.
SIM_DAYS = 1.0
#: The profiled serve-backend run of the Fig 7 phase, at PR 16's length:
#: its launches per arrival move with the run's length, so a shorter run
#: would not compare with earlier readings.
SIM_PROFILE_DAYS = 0.25
TIGHT_BUDGET_W = 12 * 112.0 + 60.0


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
    two ratios written, against the float32 operations of the sort-based
    oracle (de-trend and normalize ~8 per slot; per period a median sort
    over the repetitions, deviation, a sort of the deviations and the
    sum of the smallest 80 %)."""
    per_period = sum(t * math.log2(max(t // p, 2)) + 2 * t
                     + t * math.log2(t) + 0.8 * t for p in (48, 24, 16))
    return bound((b * t + b * 2) * 4, b * (8 * t + per_period),
                 FP32_OPS_PER_S)


def forest_bound_ms(b, f, nf, t, d, k) -> tuple[float, str]:
    """Least time for summed leaf values of NF stacked forests: features,
    forest tables and outputs moved once, against D compares and bit
    packs plus K adds per (row, forest, tree)."""
    return bound(b * f * 4 + nf * t * d * 8 + nf * t * (1 << d) * k * 4
                 + b * nf * k * 4, b * nf * t * (2 * d + k), FP32_OPS_PER_S)


def fleet_series(pop, rows: int, seed: int) -> np.ndarray:
    """(rows, T) series for the daily fleet labeling pass: population
    series resampled with per-VM scale and per-slot jitter."""
    rng = np.random.default_rng(seed)
    base = pop.series[rng.integers(0, len(pop.vms), rows)]
    jitter = base * rng.uniform(0.9, 1.1, (rows, 1)) \
        + rng.normal(0.0, 1.0, base.shape)
    return np.clip(jitter, 0.0, 100.0).astype(np.float32)


def template_phase(series: np.ndarray, dev, timed: bool = True) -> dict:
    """The template kernel against its plain version on one input, with
    both timed and the bound when `timed`."""
    import torch
    from repro_torch.kernels.template import ops, ref
    x = torch.as_tensor(series, device=dev)
    got = ops.criticality_scores(x)
    want = ref.criticality_scores_ref(x)
    torch.cuda.synchronize()
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "template scores finite")
    check(bool((err <= TEMPLATE_ATOL + TEMPLATE_RTOL * want.abs()).all()),
          f"template kernel within rtol {TEMPLATE_RTOL} atol "
          f"{TEMPLATE_ATOL} of its plain version")
    agree = ((got[:, 0] < 0.72) == (want[:, 0] < 0.72)).float().mean()
    out = {"shape": list(series.shape), "max_abs_err": err.max().item(),
           "max_rel_err": (err / want.abs().clamp(min=1e-12)).max().item(),
           "label_agreement": agree.item()}
    if timed:
        out["ms"] = cuda_ms(lambda: ops.criticality_scores(x))
        out["plain_ms"] = cuda_ms(lambda: ref.criticality_scores_ref(x))
        out["bound_ms"], out["bound_by"] = template_bound_ms(*series.shape)
        kernel_times(out, lambda: ops.criticality_scores(x),
                     "criticality_kernel")
    return out


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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (traced or fn)()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    named = {k: [sum(e.self_device_time_total for e in dev if k in e.key)
                 / 1e3, sum(e.count for e in dev if k in e.key)]
             for k in kernels}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms or "not measured",
            "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms
            else "not measured",
            "launches": sum(e.count for e in events
                            if e.key == "cudaLaunchKernel"),
            "top_device_ms": [[e.key[:48], e.self_device_time_total / 1e3,
                               e.count] for e in top],
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
    (2 D operations each for QK^T and for PV)."""
    pairs = sum(min(lk, lk - lq + i + 1) for i in range(lq))
    return 4 * d * pairs * b * h


def flash_bound_ms(b, h, lq, lk, d, itemsize) -> tuple[float, str]:
    """q, k, v read once and o written once, against `flash_ops` on the
    bf16 tensor cores."""
    return bound(b * h * (2 * lq + 2 * lk) * d * itemsize,
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
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        got = ops.flash_attention(qd, kd, vd, causal=True)
        want = ref.attention_ref(qd, kd, vd, causal=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(bool(torch.isfinite(got).all()), "flash output finite")
        check(err <= FLASH_ATOL[name], f"flash kernel {name} within "
              f"{FLASH_ATOL[name]} of its plain version: {err}")
        out[f"max_abs_err_{name}"] = err
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
    out["ms"] = cuda_ms(lambda: ops.ssd(xb, dt, a, bb, cb, d))
    out["device_ms"] = device_ms(lambda: ops.ssd(xb, dt, a, bb, cb, d))
    out["plain_ms"] = cuda_ms(
        lambda: ref.ssd_chunked(xb, dt, a, bb, cb, d, chunk=ch))
    out["bound_ms"], out["bound_by"] = ssd_bound_ms(b, l, 80, 64, 64, 2)
    out["bound_peaks"] = BF16_PEAKS
    rates(out, ssd_ops(b, l, 80, 64, 64))
    return out


#: Edge shapes of the bf16 tensor-core kernels that the prefill shape
#: never reaches. Flash: (B, Hq, Hkv, Lq, Lk, D, causal, window) — ragged
#: Lq, Lk > Lq, a window, GQA rep 2, D 16, 40 (not a multiple of 16) and
#: 128, non-causal. SSD: (B, L, H, P, N) — ragged L, N 128, P 16, and P,
#: N the wrapper pads to multiples of 8.
FLASH_EDGES = [(2, 4, 2, 300, 300, 80, True, None),
               (2, 4, 2, 300, 700, 80, True, None),
               (2, 4, 2, 512, 512, 80, True, 128),
               (2, 4, 2, 300, 300, 16, True, None),
               (2, 4, 2, 300, 300, 40, True, None),
               (2, 4, 2, 300, 700, 128, True, 200),
               (2, 4, 2, 300, 700, 128, False, None)]
SSD_EDGES = [(2, 200, 80, 64, 64), (2, 200, 4, 64, 128),
             (2, 200, 4, 16, 64), (2, 300, 3, 40, 20)]


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
        q = randn(b, hq, lq, d).bfloat16()
        k, v = randn(b, hkv, lk, d).bfloat16(), randn(b, hkv, lk, d).bfloat16()
        rep = hq // hkv
        got = fops.flash_attention(q, k, v, causal=causal, window=window)
        want = fref.attention_ref(q, k.repeat_interleave(rep, 1),
                                  v.repeat_interleave(rep, 1),
                                  causal=causal, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        case = [b, hq, hkv, lq, lk, d, causal, window]
        check(bool(torch.isfinite(got).all()), f"flash edge {case} finite")
        check(err <= FLASH_ATOL["bfloat16"], f"flash edge {case} within "
              f"{FLASH_ATOL['bfloat16']} of its plain version: {err}")
        flash.append({"case": case, "max_abs_err": err})
    ssd = []
    for b, l, h, p, n in SSD_EDGES:
        x = randn(b, l, h, p).bfloat16()
        dt = torch.nn.functional.softplus(randn(b, l, h))
        a = -torch.linspace(1.0, 16.0, h, device=dev)
        bm, cm = randn(b, l, n).bfloat16(), randn(b, l, n).bfloat16()
        d = torch.ones(h, device=dev)
        got = sops.ssd(x, dt, a, bm, cm, d).float()
        want = sref.ssd_chunked(x, dt, a, bm, cm, d,
                                chunk=min(sops.CHUNK, max(l, 8))).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        case = [b, l, h, p, n]
        check(bool(torch.isfinite(got).all()), f"SSD edge {case} finite")
        check(bool((err <= SSD_BF16_ATOL + SSD_BF16_RTOL * want.abs()).all()),
              f"SSD edge {case} within {SSD_BF16_ATOL} + {SSD_BF16_RTOL} "
              "relative of its plain version")
        ssd.append({"case": case, "max_abs_err": err.max().item(),
                    "max_abs_y": want.abs().max().item()})
    return {"flash": flash, "ssd": ssd}


#: Edge shapes of the forest and template kernels. Forest: (B, NF, T, D,
#: K) at F = 18 — one row, a ragged batch, stacks over the 48 KB of
#: shared memory (T = 100 and 256 at D = 6), depths 1 and 8, K = 1, 4 and
#: 10, and a stack of 400 trees at depth 12 that takes two tree tiles.
#: Template: T = 48, 96, 480 and 1,008 slots.
FOREST_EDGES = [(1, 4, 48, 6, 2), (300, 4, 48, 6, 2), (256, 4, 100, 6, 2),
                (256, 4, 256, 6, 2), (256, 4, 48, 1, 2), (256, 4, 48, 8, 2),
                (256, 4, 48, 6, 1), (256, 4, 48, 6, 4), (256, 4, 48, 6, 10),
                (256, 1, 400, 12, 2)]
TEMPLATE_EDGES = (48, 96, 480, 1008)


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
    return {"forest": forest, "template": template}


def sass_mma_counts(lib: str) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in each kernel of the built
    library's SASS, by `cuobjdump --dump-sass`."""
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
            counts[fn] = 0
        elif fn and re.search(r"\bHG?MMA\b", ln):
            counts[fn] += 1
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
    tokens = serve_batch(cfg, params, prompts, LM_GEN, trace=trace)
    serve_launches = dict(KERNEL_LAUNCHES)

    groups = cfg.n_layers // cfg.attn_every
    check(prefill_launches["flash_attention"] == groups,
          f"flash launches {prefill_launches['flash_attention']} == "
          f"{groups} per prefill")
    check(prefill_launches["ssd"] == cfg.n_layers,
          f"SSD launches {prefill_launches['ssd']} == {cfg.n_layers} per "
          "prefill")
    lf = logits.float()
    pl = trace["prompt_logits"].float()
    check(bool(torch.isfinite(lf).all() and torch.isfinite(pl).all()),
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
                     device, **planes):
    """A streamed-cell pipeline on `device` over the warm cluster, its GB
    ledger (total and NUF slice) seeded from the warm VMs, with the
    `PlaneBundle` fields given in `planes`."""
    from repro_torch.serve import (PlaneBundle, ResourceVector, ServeConfig,
                                   ServePipeline, device_state)
    pipe = ServePipeline.from_history(
        run["svc"], hist, labels, n_servers=N_SERVERS,
        cores_per_server=CORES, blades_per_chassis=BLADES, device=device,
        config=ServeConfig(batch_size=BATCH, n_ingest_hosts=hosts,
                           planes=PlaneBundle(
                               chassis_budget=ResourceVector(watts=budget_w),
                               **planes)))
    chassis = warm[0] // BLADES
    n_chassis = N_SERVERS // BLADES
    pipe.state = device_state(
        warm_state, device=device,
        mem_gb=np.bincount(chassis, weights=warm[4], minlength=n_chassis),
        mem_nuf=np.bincount(chassis, weights=warm[4] * ~warm[3],
                            minlength=n_chassis))
    return pipe


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
    ballooned = pipe.balloon_state.ballooned_gb.double().cpu().numpy()
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
    seg = [_rows(batch, np.arange(i * 4 * BATCH, (i + 1) * 4 * BATCH))
           for i in range(2)]
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
        "profile_1024_arrivals": {k: prof[k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share", "launches")}}


def sim_emergency(dev) -> dict:
    """`simulate` with the emergency plane at the reference benchmark's
    2x settings, aware and blind, on the event backend on the host, and
    the aware run again on the serve backend on the card (its torch twin
    held bit-equal to the numpy oracle on every scan): the serve trace
    and every `SimMetrics` field equal the event backend's, aware gives
    fewer critical throttled-seconds than blind, and the numbers stand
    beside the reference's record."""
    import dataclasses
    from repro_torch.core.placement import SchedulerPolicy
    from repro_torch.serve import EmergencyConfig
    from repro_torch.sim import scheduler_sim as S
    pol, ch = SchedulerPolicy(alpha=0.8), S.PredictionChannel("ml")
    metrics, traces, secs = {}, {}, {}
    for name, backend, blind in (("aware", "event", False),
                                 ("blind", "event", True),
                                 ("aware_serve", "serve", False)):
        tr = []
        t0 = time.perf_counter()
        metrics[name] = S.simulate(pol, ch, S.SimSpec(
            emergency=EmergencyConfig.from_model(
                EMERGENCY_BUDGET_W, dwell_s=EMERGENCY_SIM_DWELL_S,
                criticality_blind=blind),
            serve=S.ServeBackendSpec(backend=backend), **EMERGENCY_SIM),
            trace=tr, device=dev)
        secs[name] = time.perf_counter() - t0
        traces[name] = tr
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
    """Both example twins on the card, each read from counts at 0, their
    printed lines captured, and the quickstart once more on the CPU."""
    import contextlib
    import io
    import torch
    from repro_torch import KERNEL_LAUNCHES, reset_launches
    from repro_torch.examples import datacenter_sim, quickstart
    out = {}
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
    for kern in ("flash_kernel_bf16", "ssd_kernel_bf16"):
        got = {k: v for k, v in mma.items() if kern in k}
        check(got and all(v > 0 for v in got.values()),
              f"every {kern} instantiation has HMMA/HGMMA instructions: "
              f"{got}")
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
    emit("serve_profile", **serve_profile(
        pipe, arrival_batch(type(rest)(vms=nxt[:BATCH])),
        arrival_batch(type(rest)(vms=nxt[BATCH:]))))

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

    # the LM serving path: prefill through the kernels, serve_batch
    # through the cache path, each read from counts at 0
    lm = lm_path(args.seed, dev)
    emit("lm_serve", **lm)

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

    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "forest_sums", "route": "cuda",
         "source": "src/repro_torch/csrc/forest.cu",
         "replaces": "src/repro/kernels/forest/forest.py:95",
         "launches": launches["forest"],
         "launches_streamed": stream["launches"]["forest"],
         "launches_examples": examples["quickstart"]["launches"]["forest"],
         "launches_streamed_planes": planes["launches"]["forest"],
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
         **{k: res_hist[k] for k in TIMES},
         "library_ms": None, "shape": res_hist["shape"],
         "edge_shapes": [r["shape"] for r in edges["template"]],
         "edge_max_rel_err": max(r["max_rel_err"]
                                 for r in edges["template"]),
         "fleet": res_fleet},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:73",
         "launches": lm["prefill_launches"]["flash_attention"],
         **{k: flash["prefill"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "shape", "tflops", "bound_share", "device_ms",
             "library_device_ms")},
         "long": flash["long"]},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd.cu",
         "replaces": "src/repro/kernels/ssd/ssd.py:77",
         "launches": lm["prefill_launches"]["ssd"],
         **{k: ssd["prefill"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "shape", "tflops", "bound_share", "device_ms")},
         "library_ms": None, "long": ssd["long"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
