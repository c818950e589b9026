#!/usr/bin/env python3
"""Time the template kernel's block path (T past 1,024 slots) on one
NVIDIA card.

    python tools/template_variants.py [--parent DIR] [--rows N] [--out FILE]

Builds the block kernel of `src/repro_torch/csrc/template.cu` (through
`tools/template_variants.cu`, which adds its trace points) with the
port's nvcc flags and, with `--parent DIR` (a checkout of an earlier
commit, e.g. unpacked by `git archive`), that commit's `template.cu`
from its sources. At 8,000 x 1,440 and 8,000 x 4,320 slots (30 and 90
days of a day's fleet labeling batch, chip_smoke.py's `template_long_*`
inputs), at 2,000 x 28,800 (600 days: the medians' digit select) and on
8,000 x 4,320 rows whose every deviation ties (constant rows: every
pattern of every digit round in one bin), it checks each kernel against
the plain version (rtol 5e-3 / atol 5e-4, labels equal) and times it in
turns (parent, block, block, parent): device ms a call, the median of 7
runs of 20 back-to-back calls between CUDA events (`*_ms`), and the
kernel's own device time a call from torch.profiler (`*_kernel_ms`);
beside them the plain version's ms, the byte bound and the bound from
the selects' operations (`chip_smoke.template_bound_ms`), and the SM
clocks a row of the block kernel spends in each phase, from its trace
points (the median row of one call; rows share their SM, so these are
residence times). One JSON line per shape; the card's
name and power limit first. Needs a card and the CUDA toolkit; imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from flash_variants import kernel_ms, nvcc_lib  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
KEEP_FRAC = 0.8


def inputs(pop, rows: int, seed: int) -> dict:
    """name -> (rows, T) float32 series."""
    out = {f"long_{t}": cs.fleet_series(pop, rows, seed + t, t)
           for t in cs.TEMPLATE_LONG_T}
    # 600 days, past the medians' register walk (128 days): a quarter of
    # the rows
    out["long_28800"] = cs.fleet_series(pop, rows // 4, seed + 28800, 28800)
    levels = np.random.default_rng(seed).choice([0.0, 25.0, 50.0, 100.0],
                                                (rows, 1))
    out["ties_4320"] = np.repeat(levels, 4320, 1).astype(np.float32)
    return out


#: The kernel's trace points (`TR_*` in template.cu), in order.
PHASES = ("cumsum", "detrend", "normalize", "medians", "select", "sums")


def traced(lib, x, o, k) -> dict:
    """SM clocks a row spends in each phase of the block kernel
    (median over the rows of one traced call, after a warm call), and
    each phase's share of the row."""
    import torch
    b, t = x.shape
    n = lib.criticality_trace_points()
    tr = torch.zeros((b, n), dtype=torch.int64, device=x.device)
    for _ in range(2):
        err = lib.criticality_long_variant(
            x.data_ptr(), o.data_ptr(), b, t, k, tr.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
    torch.cuda.synchronize()
    d = (tr[:, 1:] - tr[:, :-1]).double().median(0).values.tolist()
    total = float((tr[:, -1] - tr[:, 0]).double().median())
    return {"row_clocks": total,
            **{p: v for p, v in zip(PHASES, d)},
            "shares": {p: v / total for p, v in zip(PHASES, d)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--rows", type=int, default=cs.TEMPLATE_LONG_ROWS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("template_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.template import ops, ref
    from repro_torch.sim.telemetry import generate_population
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    out_dir = ROOT / "build" / "template_variants"
    lib = nvcc_lib(ROOT / "tools" / "template_variants.cu",
                   out_dir / "libtemplate_variants.so", csrc, "block_kernel")
    lib.criticality_long_variant.argtypes = [_P, _P] + [_I] * 3 + [_P, _P]
    lib.criticality_long_variant.restype = _I
    parent = None
    if args.parent is not None:
        psrc = args.parent / "src" / "repro_torch" / "csrc"
        parent = nvcc_lib(psrc / "template.cu",
                          out_dir / "libtemplate_parent.so", psrc,
                          "block_kernel")
        parent.criticality_scores_long.argtypes = [_P, _P] + [_I] * 3 + [_P]
        parent.criticality_scores_long.restype = _I

    dev = torch.device("cuda")
    pop = generate_population(cs.N_VMS, seed=args.seed)
    results = []
    for name, series in inputs(pop, args.rows, args.seed).items():
        b, t = series.shape
        k = ops.keep_count(t, KEEP_FRAC)
        x = torch.as_tensor(series, device=dev)
        o = torch.empty((b, 2), dtype=torch.float32, device=dev)
        want = ref.criticality_scores_ref(x, KEEP_FRAC)

        def entry(fn, *extra):
            def call():
                err = fn(x.data_ptr(), o.data_ptr(), b, t, k, *extra,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError_t {err}")
            return call

        runs = {"block": entry(lib.criticality_long_variant, None)}
        if parent:
            runs["parent"] = entry(parent.criticality_scores_long)
        bound_ms, bound_by = cs.template_bound_ms(b, t)
        rec = {"shape": name, "b_t": [b, t], "k": k, "bound_ms": bound_ms,
               "bound_by": bound_by}
        for who, call in runs.items():
            o.zero_()
            call()
            torch.cuda.synchronize()
            err = (o - want).abs()
            rec[f"{who}_max_abs_err"] = err.max().item()
            rec[f"{who}_ok"] = bool(
                (err <= cs.TEMPLATE_ATOL + cs.TEMPLATE_RTOL * want.abs())
                .all()) and bool(torch.equal(o[:, 0] < 0.72,
                                             want[:, 0] < 0.72))
        order = [w for w in ("parent", "block") if w in runs]
        times = {w: [] for w in order}
        for who in order + order[::-1]:
            times[who].append(cs.device_ms(runs[who]))
        for who in order:
            rec[f"{who}_ms"] = times[who]
            rec[f"{who}_kernel_ms"] = kernel_ms(runs[who])
            rec[f"{who}_bound_share"] = bound_ms / rec[f"{who}_kernel_ms"]
        rec["phase_clocks"] = traced(lib, x, o, k)
        rec["port_ms"] = cs.device_ms(
            lambda: ops.criticality_scores(x, KEEP_FRAC))
        rec["plain_ms"] = cs.device_ms(
            lambda: ref.criticality_scores_ref(x, KEEP_FRAC), calls=3,
            runs=3)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "shapes": results},
                                       indent=1))
    return 0 if all(v for r in results for key, v in r.items()
                    if key.endswith("_ok")) else 1


if __name__ == "__main__":
    sys.exit(main())
