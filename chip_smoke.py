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
  cache path, and the kernel forward against the plain forward.

Each phase prints one JSON line. Then come the card's name and power
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


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
    for lo in range(0, len(batch), BATCH):
        chunk = type(batch)(*(getattr(batch, f)[lo:lo + BATCH]
                              for f in type(batch).__dataclass_fields__))
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

    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "forest_sums", "route": "cuda",
         "source": "src/repro_torch/csrc/forest.cu",
         "replaces": "src/repro/kernels/forest/forest.py:95",
         "launches": launches["forest"],
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
