"""The benchmark's harness: runs one cell of `BENCHMARK.json` once.

Everything that belongs to one configuration, traffic mix, entry,
model family or metric is a file of its own, found by name:

  portbench/configs/<config>.json   sizes of a configuration as run
  portbench/traffic/<mix>.json      entry, batch, lengths, generated
  portbench/entries/<entry>.py      drives one entry of the program
  portbench/reference/<family>.py   plain float32 model of a family
  portbench/params/<family>.py      a family's seeded weights (`make`)
  portbench/arithmetic/<family>.py  a family's whole-step counts
  portbench/metrics/<metric>.py     reads one metric (`read(ctx)`)
  portbench/limits/<cell>.json      the limit `correct` is judged by

A run makes the weights (one draw for every seed, put in the seed's
order) and the token ids from the seed, warms the
shapes the traffic uses, then issues batches back to back for the
window's seconds (the batch in flight when they run out is finished and
counted). With tracing on, the profiler records the window's first
`trace_batches` batches. Once the window has closed and the peak memory
is read, the reference runs on a sample of the finished requests drawn
from the seed, and `correct` says whether the served tokens' logits lie
within the cell's limits of the reference's best.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HERE = Path(__file__).resolve().parent
#: Top-level modules the harness's process may never hold: JAX and the
#: JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def find(kind: str, name: str, ext: str, roots=()) -> Path:
    """The file of `kind` named `name`: under each of `roots` in turn,
    then beside this module."""
    for base in (*roots, HERE):
        p = base / kind / f"{name}{ext}"
        if p.is_file():
            return p
    raise FileNotFoundError(f"no {kind} named {name!r} ({kind}/{name}{ext} "
                            f"under {', '.join(map(str, (*roots, HERE)))})")


def load(kind: str, name: str, roots=()):
    """The module of `kind` named `name`, loaded from its file (`find`);
    loaded anew where the module of that name came from another file."""
    path = find(kind, name, ".py", roots)
    key = f"{HERE.name}.{kind}._{name.replace('.', '_').replace('-', '_')}"
    mod = sys.modules.get(key)
    if mod is None or mod.__file__ != str(path):
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        mod.__package__ = f"{HERE.name}.{kind}"
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


class Bench:
    """`BENCHMARK.json` under `root`, and the files it names. A file is
    looked up under `root`/portbench first, then beside this module."""

    def __init__(self, root):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.roots = (self.root / HERE.name,)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads(find("traffic", name, ".json", self.roots)
                          .read_text())

    def limits(self, cell: str) -> dict:
        return json.loads(find("limits", cell, ".json", self.roots)
                          .read_text())

    def module(self, kind: str, name: str):
        """The module of `kind` named `name`, loaded from its file."""
        return load(kind, name, self.roots)

    def metrics(self, cell: str, kind: str) -> list:
        """The cell's `end_to_end` or `per_layer` metrics: those whose
        `workloads` list it; an end-to-end metric without the key is
        every cell's. A per-layer metric has to name its cells."""
        out = []
        for m in self.spec[kind]:
            if kind == "per_layer" and "workloads" not in m:
                raise ValueError(f"per-layer metric {m['name']!r} names "
                                 f"no workloads")
            if cell in m.get("workloads", [cell]):
                out.append(m)
        return out


def model_config(cfg_file: dict):
    """The port's configuration for `arch`, with every size the file
    states; a size the file leaves out is refused, so the file holds the
    configuration as it is run."""
    from repro_torch.configs import get_config
    base = get_config(cfg_file["arch"])
    model = cfg_file["model"]
    shape = {f.name for f in dataclasses.fields(base)} - {
        "name", "source", "optimizer", "grad_accum_dtype", "remat",
        "sub_quadratic", "mrope_sections", "encoder_frames"}
    missing = sorted(shape - set(model))
    if missing:
        raise ValueError(f"{cfg_file['arch']}: the configuration file does "
                         f"not state {missing}")
    return dataclasses.replace(base, **model)


#: The weights' torch seed, the same for every run. Where the weights
#: changed with the seed, so did the experts' loads, and with them the
#: rows the expert products compute and the step's time: a run's seed
#: draws the order of the weights (`make_params`' `order`, each layer's
#: experts), so that every seed routes the same loads to the experts, in
#: another order.
WEIGHTS_SEED = 0


def seeds(seed: int) -> dict:
    """Independent streams of one seed: the weights' torch seed
    (`WEIGHTS_SEED`) and numpy generators for the weights' order, the
    token ids, the warm-up and the check's sample."""
    ss = np.random.SeedSequence(int(seed) % 2 ** 64)
    order, traffic, warm, sample = ss.spawn(4)
    return {"weights": WEIGHTS_SEED, "order": np.random.default_rng(order),
            "traffic": np.random.default_rng(traffic),
            "warm": np.random.default_rng(warm),
            "sample": np.random.default_rng(sample)}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_line() -> str:
    """The card's name and power limit, as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        out = f"not read ({err})"
    return f"portbench device (nvidia-smi name, power.limit): {out}"


class CellRun:
    """One run of one cell: `setup`, `window`, then `check`."""

    def __init__(self, bench: Bench, workload: str, seed: int, device):
        import torch
        self.bench, self.device = bench, torch.device(device)
        self.cell = bench.cell(workload)
        self.config = bench.config(self.cell["config"])
        self.cfg = model_config(self.config)
        self.traffic = bench.traffic(self.cell["traffic"])
        self.limits = bench.limits(self.cell["name"])
        self.streams = seeds(seed)
        self.records, self.trace = [], None

    def setup(self) -> None:
        """Load the kernels, make the weights, warm the traffic's shapes;
        `stages` holds the host seconds at which each step ended."""
        import torch

        from portbench.weights import make_params
        cuda = self.device.type == "cuda"
        self.stages = {"imported": time.perf_counter()}
        if cuda:
            torch.cuda.init()
            torch.empty(1, device=self.device)
            self.stages["context"] = time.perf_counter()
            from repro_torch.kernels import build
            build.load()
            self.stages["library"] = time.perf_counter()
        self.params = make_params(self.cfg, self.streams["weights"],
                                  self.device, find=self.bench.module,
                                  order=self.streams["order"])
        if cuda:
            torch.cuda.synchronize(self.device)
        self.stages["weights"] = time.perf_counter()
        mod = self.bench.module("entries", self.traffic["entry"])
        self.entry = mod.Entry(self.cfg, self.params, self.traffic,
                               self.streams["traffic"], self.device)
        self.entry.warm(self.streams["warm"])
        if cuda:
            torch.cuda.synchronize(self.device)
        self.stages["warm"] = time.perf_counter()

    def window(self, seconds: float, trace: bool) -> None:
        """Batches back to back for `seconds`, the first
        `trace_batches` under the profiler when `trace` is set."""
        from portbench.trace import traced
        t0 = time.perf_counter()
        self.t0 = t0
        if trace:
            k = int(self.traffic["trace_batches"])
            self.records, self.trace = traced(
                lambda: [self.entry.issue(i) for i in range(k)])
        while time.perf_counter() - t0 < seconds:
            self.records.append(self.entry.issue(len(self.records)))

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return max(torch.cuda.max_memory_allocated(d)
                   for d in range(torch.cuda.device_count()))

    def check(self, control: bool = False) -> dict:
        """Frees the program's state and runs the reference over the
        sample. Returns the gaps by which the served tokens' logits lie
        below the reference's best at their positions (`_summary`). With
        `control`, the same of the tokens the fp8 control puts first at
        those positions, under `control_*`."""
        import torch
        self.entry.release()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        batches, reads, served = self.entry.check_inputs(
            self.records, self.streams["sample"])
        ref = self.bench.module("reference", self.cfg.family)
        kw = dict(capacity_factor=self.entry.capacity_factor)
        with torch.no_grad():
            logits = ref.forward(self.cfg, self.params, batches, reads, **kw)
            gaps = torch.cat([_gaps(lg, torch.as_tensor(s, device=lg.device))
                              .flatten() for lg, s in zip(logits, served)])
            out = _summary(gaps)
            if control:
                ctl = ref.forward(self.cfg, self.params, batches, reads,
                                  control=True, **kw)
                ctl_gaps = torch.cat([_gaps(lg, c.argmax(-1)).flatten()
                                      for lg, c in zip(logits, ctl)])
                out.update({f"control_{k}": v
                            for k, v in _summary(ctl_gaps).items()})
        return out

    def context(self, setup_s: float) -> SimpleNamespace:
        from portbench import roofline
        k = int(self.traffic["trace_batches"]) if self.trace else 0
        return SimpleNamespace(cfg=self.cfg, config=self.config,
                               traffic=self.traffic, cell=self.cell,
                               setup_s=setup_s, records=self.records,
                               trace=self.trace,
                               trace_records=self.records[:k],
                               roofline=roofline.at(self.bench.module))


def _summary(gaps) -> dict:
    """The widest and the mean gap, the share of gaps that are 0 (the
    reference's own choice) and how many tokens were checked."""
    return {"widest_gap": gaps.max().item(), "mean_gap": gaps.mean().item(),
            "agree_share": (gaps == 0).float().mean().item(),
            "served_checked": gaps.numel()}


def _gaps(logits, tokens):
    """The reference's best logit minus its logit of each token, per
    position: logits (B, n, V), tokens (B, n)."""
    tokens = tokens.to(logits.device).long()
    return logits.amax(-1) - logits.gather(-1, tokens[..., None])[..., 0]


def read_metrics(bench: Bench, run: CellRun, kind: str, ctx) -> dict:
    out = {}
    for m in bench.metrics(run.cell["name"], kind):
        v = bench.module("metrics", m["name"]).read(ctx)
        if v is None:
            if kind == "end_to_end":
                raise RuntimeError(f"no reading of {m['name']} in "
                                   f"{run.cell['name']}")
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, emit=print) -> dict:
    """Run one cell once and return its result line (a dict); `t_start`
    is the process's start on `time.perf_counter`'s clock."""
    import torch
    bench = Bench(root)
    run = CellRun(bench, workload, seed, device)
    run.setup()
    setup_s = time.perf_counter() - t_start
    run.window(seconds, trace)
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    peak = run.memory_peak()
    failed = sum(int(((r["served"] < 0)
                      | (r["served"] >= run.cfg.vocab_size)).any(-1).sum())
                 for r in run.records)
    ctx = run.context(setup_s)
    metrics = read_metrics(bench, run, "per_layer" if trace
                           else "end_to_end", ctx)
    breakdown = run.trace.breakdown() if trace else None
    if run.device.type == "cuda":
        emit(device_line())
    t_check = time.perf_counter()
    got = run.check()
    check_s = time.perf_counter() - t_check
    checks = {k: {"value": got[k], "limit": v["limit"]}
              for k, v in run.limits.items()}
    correct = failed == 0 and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(run.device)
           if run.device.type == "cuda" else "cpu",
           "count": int(run.cell["chips"]), "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    line = {"correct": bool(correct),
            "attempted": sum(r["batch"] for r in run.records),
            "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["timing"] = {"window_s": run.records[-1]["t1"] - run.t0,
                      "batches": len(run.records), "check_s": check_s,
                      "setup_stages_s": {k: v - t_start
                                         for k, v in run.stages.items()}}
    line["sample"] = got
    line["checks"] = checks
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    return line


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("the process holds " + ", ".join(names))
        self.names = names
