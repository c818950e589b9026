#!/usr/bin/env python3
"""Check the prefill step's spans on one NVIDIA card, and cost them.

    python tools/step_spans.py check [--seed N] [--out FILE] [--root DIR]
        [--cell NAME] [--device DEV]
    python tools/step_spans.py run {on,off,norf} -- <portbench/run.py arguments>
    python tools/step_spans.py window {on,off,norf} [--seed N]

`check` sets up the benchmark's cell `mixtral-8x22b.prefill-azure`
(`portbench.harness.CellRun`: its weights, its traffic's two lengths
warmed; `--root` and `--cell` name another benchmark root and cell,
`--device` another device, for a rehearsal at a small size), then:

- under ``torch.profiler`` (CPU and CUDA activity) over one batch of
  each length: every span's ``record_function`` event lies within 1 ms
  of its `time.time_ns` start; each `experts` span's host interval
  encloses the launch calls of its GEMMs (three a kept-rows expert) and
  of no other span's; the device time of every kernel by the innermost
  span that launched it (so the cuBLAS tiles split into the experts' and
  the projections'), beside the spans' own device times, and the expert
  GEMMs' rate over the rows the `experts` spans count; the device's
  idle gaps in those batches by the span that launched the next kernel;
- the benchmark's traced reading (`portbench.trace.traced`, CUDA
  activity only) over 4 batches with the spans on and off, in turns:
  busy and window seconds, and no span of the program among its device
  operations;
- host seconds of 10 batches with the spans on and off, in turns;
- the three MoE readers over 24 batches.

`run` runs `portbench/run.py` with the step tracer on (the default), off
(`make_prefill_step(..., tracer=None)`) or on without its
``record_function`` ranges under a profiler (`norf`), after the same
imports in every arm. `window` sets up the cell in that arm and prints
what the benchmark's traced window reads over its first
`trace_batches` batches (busy and window seconds, the idle gaps), as a
`--trace 1` run would, without the run's check. Lines of JSON; the
card's name and power limit first. Imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import argparse
import functools
import json
import runpy
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
CELL = "mixtral-8x22b.prefill-azure"
GEMM = ("nvjet", "gemm", "cutlass", "Kernel2")
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel")


def emit(out: list, **row) -> None:
    print(json.dumps(row), flush=True)
    out.append(row)


def profile_batches(run, lengths) -> tuple:
    """(kineto events, the step tracer's spans of those batches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.tracing import STEP_TRACER
    seq0 = STEP_TRACER._next_seq
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i, _ in enumerate(lengths):
            run.entry.issue(i)
        torch.cuda.synchronize()
    spans = STEP_TRACER.resolve()
    return (list(prof.profiler.kineto_results.events()),
            spans[spans["seq"] >= seq0])


def launches_by_kernel(events) -> tuple:
    """{kernel event index: its launch call}, matched by correlation id
    (either of the kernel's ids), else in order on the one stream."""
    from torch.autograd import DeviceType
    calls = [e for e in events if e.device_type() != DeviceType.CUDA
             and e.name().startswith(LAUNCH)]
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()
               and not e.name().startswith(("Memcpy", "Memset"))]
    by_id = {c.correlation_id(): c for c in calls}
    out, how = {}, "correlation"
    for i, k in enumerate(kernels):
        c = by_id.get(k.correlation_id()) or \
            by_id.get(k.linked_correlation_id())
        if c is not None:
            out[i] = c
    if len(out) < len(kernels) and len(calls) == len(kernels):
        how = "order"
        out = dict(enumerate(sorted(calls, key=lambda c: c.start_ns())))
        kernels = sorted(kernels, key=lambda k: k.start_ns())
    return kernels, out, how


def innermost(spans, t_ns: int):
    """The shortest span whose host interval holds t_ns, or None."""
    hit = spans[(spans["t0_ns"] <= t_ns)
                & (spans["t0_ns"] + spans["host_ns"] >= t_ns)]
    return None if not len(hit) else hit[hit["host_ns"].argmin()]


def idle_gaps(events, kernels, launch, spans, top: int = 12) -> dict:
    """The device's idle time between its operations (kernels, copies,
    sets) from the first to the last, each gap named by the span that
    launched the kernel after it ("?" for a copy or a set) and that
    kernel's name: the window, the idle sum and the largest names
    (count, ms)."""
    from torch.autograd import DeviceType
    ops = sorted((e for e in events if e.device_type() == DeviceType.CUDA
                  and not e.is_user_annotation()),
                 key=lambda e: e.start_ns())
    owner = {id(k): launch[i] for i, k in enumerate(kernels) if i in launch}
    by, end = {}, ops[0].start_ns() if ops else 0
    for e in ops:
        gap = e.start_ns() - end
        end = max(end, e.start_ns() + e.duration_ns())
        if gap <= 0:
            continue
        call = owner.get(id(e))
        span = None if call is None else innermost(spans, call.start_ns())
        key = ("?" if span is None else str(span["name"])) \
            + " before " + e.name()[:40]
        row = by.setdefault(key, [0, 0.0])
        row[0] += 1
        row[1] += gap / 1e6
    names = sorted(by.items(), key=lambda kv: -kv[1][1])[:top]
    return {"window_ms": (end - ops[0].start_ns()) / 1e6 if ops else 0.0,
            "idle_ms": sum(v[1] for v in by.values()),
            "largest": [[k, n, ms] for k, (n, ms) in names]}


def check(args) -> int:
    import numpy as np
    import torch

    from portbench import roofline
    from portbench.harness import Bench, CellRun, device_line
    from portbench.trace import traced
    from repro_torch.launch.steps import make_prefill_step
    out = []
    emit(out, device=device_line(), torch=torch.__version__)
    t = time.perf_counter()
    run = CellRun(Bench(args.root), args.cell, args.seed, args.device)
    run.setup()
    emit(out, phase="setup", seconds=time.perf_counter() - t)
    on = run.entry.step
    off = make_prefill_step(run.cfg, impl=run.traffic["impl"], tracer=None)

    events, spans = profile_batches(run, run.entry.lengths)
    names = {}
    for e in events:
        if e.is_user_annotation():
            names.setdefault(e.name(), []).append(e.start_ns())
    gaps = [min((abs(s - int(r["t0_ns"])) for s in names.get(str(r["name"]),
                                                              [])),
                default=None) for r in spans]
    emit(out, phase="clock", spans=len(spans),
         unmatched=sum(g is None for g in gaps),
         widest_ms=max(g for g in gaps if g is not None) / 1e6)

    kernels, launch, how = launches_by_kernel(events)
    by_span, gemms_in = {}, {}
    for i, k in enumerate(kernels):
        call = launch.get(i)
        owner = None if call is None else innermost(spans, call.start_ns())
        key = "unmatched" if call is None else (
            "outside" if owner is None else str(owner["name"]))
        gemm = any(g in k.name() for g in GEMM)
        row = by_span.setdefault(key, {"kernels": 0, "kernel_s": 0.0,
                                       "gemm_s": 0.0, "gemms": 0})
        row["kernels"] += 1
        row["kernel_s"] += k.duration_ns() / 1e9
        if gemm:
            row["gemm_s"] += k.duration_ns() / 1e9
            row["gemms"] += 1
            if owner is not None and owner["name"] == "experts":
                gemms_in[int(owner["seq"])] = \
                    gemms_in.get(int(owner["seq"]), 0) + 1
    experts = spans[spans["name"] == "experts"]
    own = {str(n): float(spans["device_ns"][spans["name"] == n].sum()) / 1e9
           for n in np.unique(spans["name"])}
    emit(out, phase="launches", matched_by=how, kernels=len(kernels),
         experts_spans=len(experts),
         gemms_per_experts_span=sorted(set(gemms_in.get(int(s), 0)
                                           for s in experts["seq"])),
         by_innermost_span=by_span, span_device_s=own,
         experts_rows=int(experts["rows"].sum()),
         experts_kept=int(experts["kept"].sum()),
         experts_gemm_tflops=int(experts["rows"].sum()) * 6.0
         * run.cfg.d_model * (run.cfg.moe_d_ff or run.cfg.d_ff)
         / by_span.get("experts", {}).get("gemm_s", float("nan")) / 1e12)

    emit(out, phase="gaps", **idle_gaps(events, kernels, launch, spans))

    for arm, step in (("on", on), ("off", off), ("on", on), ("off", off)):
        run.entry.step = step
        _, tr = traced(lambda: [run.entry.issue(i) for i in range(4)])
        leak = sum(1 for s in tr.device if s.name in own)
        emit(out, phase="traced", arm=arm, busy_s=tr.busy_s,
             window_s=tr.window_s, idle_pct=100 * (1 - tr.busy_s
                                                   / tr.window_s),
             span_names_among_device_ops=leak, launch_calls=tr.launch_calls)

    host = {"on": [], "off": []}
    for arm, step in (("on", on), ("off", off)) * 3:
        run.entry.step = step
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(10):
            run.entry.issue(i)
        host[arm].append(time.perf_counter() - t)
    emit(out, phase="host_10_batches", **{k: v for k, v in host.items()},
         on_over_off=statistics.median(host["on"])
         / statistics.median(host["off"]))

    run.entry.step = on
    records = [run.entry.issue(i) for i in range(24)]
    ctx = SimpleNamespace(cfg=run.cfg, roofline=roofline, records=records)
    bench = Bench(args.root)
    emit(out, phase="readers", **{
        m: bench.module("metrics", m).read(ctx)
        for m in ("moe_us_per_token.prefill", "expert_ffn_roofline.prefill",
                  "expert_rows_useful.prefill")})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


def set_arm(arm: str) -> None:
    """The step tracer as `arm` has it: "on" (the default), "off" (no
    tracer) or "norf" (no record_function under a profiler)."""
    import torch  # noqa: F401  (every arm imports the same first)

    import repro_torch.launch.steps as S
    from repro_torch.obs import tracing
    if arm == "off":
        S.make_prefill_step = functools.partial(S.make_prefill_step,
                                                tracer=None)
    elif arm == "norf":
        tracing._profiler_on = lambda: False


def window(args) -> int:
    """The benchmark's traced window in the arm `args.arm`."""
    from portbench.harness import Bench, CellRun, device_line
    from portbench.trace import traced
    set_arm(args.arm)
    run = CellRun(Bench(ROOT), CELL, args.seed, "cuda")
    run.setup()
    k = int(run.traffic["trace_batches"])
    _, tr = traced(lambda: [run.entry.issue(i) for i in range(k)])
    gaps = tr.breakdown()["idle_gaps"][:6]
    print(json.dumps({"device": device_line(), "arm": args.arm,
                      "seed": args.seed, "busy_s": tr.busy_s,
                      "window_s": tr.window_s,
                      "idle_pct": 100 * (1 - tr.busy_s / tr.window_s),
                      "launch_calls": tr.launch_calls,
                      "idle_gaps_ms": [[n[:48], 1e3 * v] for n, v in gaps]}),
          flush=True)
    return 0


def run_bench(arm: str, argv: list) -> int:
    """portbench/run.py in the step tracer's `arm` (`set_arm`)."""
    set_arm(arm)
    sys.argv = [str(ROOT / "portbench" / "run.py"), *argv]
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    except SystemExit as done:
        return int(done.code or 0)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check")
    c.add_argument("--seed", type=int, default=2147483901)
    c.add_argument("--out")
    c.add_argument("--root", default=str(ROOT))
    c.add_argument("--cell", default=CELL)
    c.add_argument("--device", default="cuda")
    r = sub.add_parser("run")
    r.add_argument("arm", choices=("on", "off", "norf"))
    r.add_argument("rest", nargs=argparse.REMAINDER)
    w = sub.add_parser("window")
    w.add_argument("arm", choices=("on", "off", "norf"))
    w.add_argument("--seed", type=int, default=2147483901)
    args = ap.parse_args(argv)
    if args.cmd == "check":
        return check(args)
    if args.cmd == "window":
        return window(args)
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    return run_bench(args.arm, rest)


if __name__ == "__main__":
    sys.exit(main())
