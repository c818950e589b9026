#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels from `src/repro_torch/csrc`, holds each
kernel against its plain torch version on the card, and drives the
port's main path at the full width of one real cluster: label an 8,000-VM
history with the template kernel, train the four forests on the host,
and serve 4,096 arrivals in micro-batches of 256 on 720 servers (60
chassis x 12 blades x 40 cores) under a chassis watt budget, with the
forest kernel on every micro-batch. It then checks the decisions
(outcome counts, capacity and power ceilings, kernel launch counts, and
identical servers from the same serve run through the port on the CPU).

Each phase prints one JSON line. Then come the card's name and power
limit as `nvidia-smi` prints them, a `{"kernels": [...]}` line with each
kernel's launches on the main path, error against its plain version,
times and bound, and last `{"ok": true, "device": {...}}`. It exits
non-zero, with no result, when no CUDA device is present, and on any
failed check. It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: H100 SXM data-sheet peaks: HBM bytes/s and
#: float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: Main-path cluster: the 720-server cluster of BENCH_serve.json.
N_SERVERS, CORES, BLADES = 720, 40, 12
N_VMS, N_ARRIVALS, BATCH = 16000, 4096, 256
FLEET_ROWS = 65536
TEMPLATE_RTOL, TEMPLATE_ATOL = 5e-3, 5e-4
FOREST_ATOL = 1e-5
TIMED_RUNS = 20


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


def template_bound_ms(b: int, t: int) -> tuple[float, str]:
    """Least time for (B, T) template scores: each series read once and
    two ratios written, against the float32 operations of the sort-based
    oracle (de-trend and normalize ~8 per slot; per period a median sort
    over the repetitions, deviation, a sort of the deviations and the
    sum of the smallest 80 %)."""
    by = (b * t + b * 2) * 4 / HBM_BYTES_PER_S * 1e3
    per_period = sum(t * math.log2(max(t // p, 2)) + 2 * t
                     + t * math.log2(t) + 0.8 * t for p in (48, 24, 16))
    ops = b * (8 * t + per_period) / FP32_OPS_PER_S * 1e3
    return (by, "bytes") if by >= ops else (ops, "operations")


def forest_bound_ms(b, f, nf, t, d, k) -> tuple[float, str]:
    """Least time for summed leaf values of NF stacked forests: features,
    forest tables and outputs moved once, against D compares and bit
    packs plus K adds per (row, forest, tree)."""
    by = (b * f * 4 + nf * t * d * 8 + nf * t * (1 << d) * k * 4
          + b * nf * k * 4) / HBM_BYTES_PER_S * 1e3
    ops = b * nf * t * (2 * d + k) / FP32_OPS_PER_S * 1e3
    return (by, "bytes") if by >= ops else (ops, "operations")


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
    given), and the sums over T trees within FOREST_ATOL once divided by
    T — the RF mean the gate reads, and the bar tests/test_kernels.py
    holds the tiled Pallas kernel to. (The kernel adds the trees in
    order, the plain version in the card's reduction order; sums near 48
    differ by a few float32 ulps, ~4e-6 each.)"""
    import torch
    from repro_torch.kernels.forest import ops, ref
    got = ops.forest_sums(x, *stacked)
    want = ref.forest_sums_ref(x, *stacked)
    idx = leaf_index_probe(x, stacked)
    idx_ref = ref.leaf_index_ref(x, stacked.feat_idx, stacked.thr)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    n_trees = stacked.feat_idx.shape[1]
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
    check(err / n_trees <= FOREST_ATOL,
          f"forest sums / T within {FOREST_ATOL}: {err / n_trees}")
    return {"shape": [x.shape[0], *stacked.leaf.shape],
            "max_abs_err": err, "max_abs_err_per_tree": err / n_trees,
            "leaf_indices_equal": True}


def serve_profile(pipe, batch_a, batch_b) -> dict:
    """Where a served micro-batch's time goes: host wall of `batch_a`,
    unprofiled, against the device time the profiler traces while
    `batch_b`, a batch like it, is served."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.serve(batch_a)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipe.serve(batch_b)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms or "not measured",
            "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms
            else "not measured",
            "launches_per_arrival": launches / len(batch_b),
            "top_device_ms": [[e.key[:48], e.self_device_time_total / 1e3,
                               e.count] for e in top]}


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
             if "registers" in ln or "Compiling entry" in ln]
    emit("build", seconds=info["seconds"], library=info["path"],
         ptxas=ptxas)

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
        emit(f"forest_{name}", **r)
        forest[name] = r

    # where a served micro-batch's time goes, on two batches after the
    # main path (their launches come after the counts were read)
    nxt = rest.vms[N_ARRIVALS:N_ARRIVALS + 2 * BATCH]
    emit("serve_profile", **serve_profile(
        pipe, arrival_batch(type(rest)(vms=nxt[:BATCH])),
        arrival_batch(type(rest)(vms=nxt[BATCH:]))))

    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "forest_sums", "route": "cuda",
         "source": "src/repro_torch/csrc/forest.cu",
         "replaces": "src/repro/kernels/forest/forest.py:95",
         "launches": launches["forest"],
         "max_abs_err": forest["micro_batch"]["max_abs_err"],
         "ms": forest["micro_batch"]["ms"],
         "plain_ms": forest["micro_batch"]["plain_ms"],
         "bound_ms": forest["micro_batch"]["bound_ms"],
         "bound_by": forest["micro_batch"]["bound_by"],
         "library_ms": None, "shape": forest["micro_batch"]["shape"],
         "batch_scoring": forest["batch_scoring"]},
        {"name": "criticality_scores", "route": "cuda",
         "source": "src/repro_torch/csrc/template.cu",
         "replaces": "src/repro/kernels/template/template.py:118",
         "launches": launches["template"],
         "max_abs_err": res_hist["max_abs_err"], "ms": res_hist["ms"],
         "plain_ms": res_hist["plain_ms"], "bound_ms": res_hist["bound_ms"],
         "bound_by": res_hist["bound_by"], "library_ms": None,
         "shape": res_hist["shape"], "fleet": res_fleet},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
