#!/usr/bin/env python3
"""Time the bf16 SSD kernel's tilings on one NVIDIA card.

    python tools/ssd_variants.py [--parent DIR] [--against DIR ...]
        [--trace] [--prefill] [--out FILE]

Builds `tools/ssd_variants.cu` (the kernel template of
`src/repro_torch/csrc/ssd.cu` at the tilings it lists) with the port's
nvcc flags and, at the shapes the SSD kernel is held to (Zamba2's
prefill 8 x 512 and one 4,096-token prompt, 80 heads, P = N = 64, bf16,
Zamba2's decays), checks each tiling against the plain version at the
bf16 bar and times it: device ms a call, the median of 7 runs of 20
back-to-back calls between CUDA events (`ms`), and the kernel's own
device time a call from torch.profiler (`kernel_ms`). Beside them, in
turns (parent, port, port, parent), it times the port's wrapper and,
with `--parent DIR` (a checkout of an earlier commit, e.g. unpacked by
`git archive`), that commit's SSD kernel built from its sources; with
`--against DIR`, the `ssd_scan` of another tree's `ssd.cu` that keeps
this one's entry point (an alternative being weighed), in the same
turns; the plain version once. `--trace` runs the library tiling, and
the same at one head a tile, with the kernel's trace points. The strided prefill reads x, B and C as the model
passes them, views of one (B, L, H P + 2N) buffer. With `--prefill`,
it also profiles one Zamba2-2.7B prefill (8 x 512) through the kernels,
in this tree and, with `--parent`, in the parent's (a subprocess with
its sources first on the path): device ms and launches by kernel, and
the copy kernels among them. One JSON line per shape; the card's name
and power limit first. Needs a card and the CUDA toolkit; imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

from flash_variants import nvcc_lib

ROOT = Path(__file__).resolve().parents[1]

#: name -> (B, L, H, P, N), and whether x, B, C are the model's views
SHAPES = {"prefill": ((8, 512, 80, 64, 64), False),
          "long": ((1, 4096, 80, 64, 64), False),
          "prefill_strided": ((8, 512, 80, 64, 64), True)}
ATOL, RTOL = 2e-2, 2.0 ** -7
_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_uint64
ENTRY = [_P] * 7 + [_I] * 5 + [_L] * 7 + [_P, _U]


def device_ms(fn, calls: int = 20, runs: int = 7) -> float:
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


def kernel_ms(fn, calls: int = 20) -> float:
    """Device ms a call of the CUDA kernels `fn` launches, from
    torch.profiler over `calls` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and "emory" not in e.key]
    return sum(e.self_device_time_total for e in dev) / 1e3 / calls


def inputs(b, l, h, p, n, strided, gen, dev):
    """Zamba2's SSD operands: x, B, C (bf16; with `strided`, views of one
    (B, L, H P + 2N) buffer), dt the softplus of a unit normal, a =
    -linspace(1, 16), D = 1."""
    import torch
    buf = torch.randn((b, l, h * p + 2 * n), generator=gen,
                      device=dev).bfloat16()
    xs, bs, cs = torch.split(buf, [h * p, n, n], dim=-1)
    x = xs.reshape(b, l, h, p)
    if not strided:
        x, bs, cs = x.contiguous(), bs.contiguous(), cs.contiguous()
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, h), generator=gen, device=dev))
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    return x, dt, a, bs, cs, torch.ones(h, device=dev)


def traced(lib, x, dt, a, bm, cm, d, y, scratch, shape, strides, epoch,
           grp) -> dict:
    """One call of the library tiling (heads a tile `grp`: 2, or 1) with
    its trace points: the median
    and 90th percentile over heads of each phase, in SM clocks (the
    products before the hand-over, the wait for the previous chunk's
    state, the hand-over, C S^T, the epilogue), and over chunks of a
    chain the global-timer ns from a state's store to the next chunk
    having it and from having it to storing its own."""
    import numpy as np
    import torch
    b, l, h, p, n = shape
    n_tr = lib.ssd_trace_points()
    n_groups, n_chunks = -(-h // grp), -(-l // 64)
    tr = torch.zeros((n_chunks, b, n_groups, grp, n_tr), dtype=torch.int64,
                     device=x.device)
    lib.ssd_variant_trace.argtypes = ENTRY + [_I, _P, _P]
    lib.ssd_variant_trace.restype = _I
    for _ in range(2):      # warm, then the traced call
        epoch[0] += 1
        err = lib.ssd_variant_trace(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), d.data_ptr(), y.data_ptr(), b, l, h, p, n,
            *strides[0], *strides[1], *strides[2], scratch.data_ptr(),
            epoch[0], grp, tr.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
    torch.cuda.synchronize()
    t = tr.cpu().numpy().reshape(n_chunks, b, n_groups * grp, n_tr)[:, :, :h]
    head, pre, seen, pub, inter, end, seen_ns, pub_ns = np.moveaxis(t, -1, 0)
    later = slice(1, None)   # chunks > 0 wait for the previous state
    out = {}

    def stat(name, v):
        v = np.asarray(v, dtype=np.float64).ravel()
        out[name] = [float(np.median(v)), float(np.percentile(v, 90))]
    stat("pre_clk", pre - head)
    stat("wait_prev_clk", seen[later] - pre[later])
    stat("handover_clk", np.where(pub[later] > 0, pub[later] - seen[later],
                                  0))
    stat("inter_clk", inter - np.maximum(pub, pre))
    stat("epilogue_clk", end - inter)
    stat("head_clk", end - head)
    if n_chunks > 2:
        stat("seen_after_stored_ns", seen_ns[1:-1] - pub_ns[:-2])
        stat("seen_to_stored_ns", pub_ns[1:-1] - seen_ns[1:-1])
    return out


def prefill_profile(src: Path) -> dict:
    """One Zamba2-2.7B prefill (8 x 512, bf16, the kernels) of the tree
    whose sources are `src`, under torch.profiler: device ms and launches
    in all, of the SSD kernel, and of the copy kernels."""
    sys.path.insert(0, str(src))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")
    cfg = get_config("zamba2-2.7b")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    toks = torch.randint(0, cfg.vocab_size, (8, 512), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    step = make_prefill_step(cfg, impl="cuda")
    for _ in range(2):
        step(params, {"tokens": toks})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, {"tokens": toks})
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and "emory" not in e.key]

    def part(pred):
        sel = [e for e in ev if pred(e.key)]
        return [sum(e.self_device_time_total for e in sel) / 1e3,
                sum(e.count for e in sel)]
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    return {"src": str(src), "device_ms_launches": part(lambda k: True),
            "ssd_kernel": part(lambda k: "ssd_kernel" in k),
            "copy_kernels": part(lambda k: "copy" in k.lower()),
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                    for e in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--prefill", action="store_true")
    ap.add_argument("--against", type=Path, action="append", default=[])
    ap.add_argument("--trace", action="store_true",
                    help="also run the library tiling with its trace "
                    "points and print where a head's time goes")
    ap.add_argument("--prefill-only", type=Path, default=None,
                    help=argparse.SUPPRESS)  # the subprocess of --prefill
    args = ap.parse_args(argv)
    if args.prefill_only:
        print(json.dumps(prefill_profile(args.prefill_only)), flush=True)
        return 0
    sys.path.insert(0, str(ROOT / "src"))

    import torch
    if not torch.cuda.is_available():
        print("ssd_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.ssd import ops, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    out_dir = ROOT / "build" / "ssd_variants"
    lib = nvcc_lib(ROOT / "tools" / "ssd_variants.cu",
                   out_dir / "libssd_variants.so", csrc, "ssd_kernel_bf16")
    lib.ssd_variant.argtypes = ENTRY + [_I] * 4 + [_P]
    lib.ssd_variant.restype = _I
    rows = (ctypes.c_int * 400)()
    n_var = lib.ssd_variant_list(rows, 100)
    variants = [tuple(rows[4 * i:4 * i + 4]) for i in range(n_var)]
    parent = None
    if args.parent is not None:
        psrc = args.parent / "src" / "repro_torch" / "csrc"
        parent = nvcc_lib(psrc / "ssd.cu", out_dir / "libssd_parent.so",
                          psrc, "ssd_kernel_bf16")
        parent.ssd_scan.argtypes = [_P] * 7 + [_I] * 6 + [_P]
        parent.ssd_scan.restype = _I
    against = {}
    for i, tree in enumerate(args.against):
        asrc = tree / "src" / "repro_torch" / "csrc"
        alt = nvcc_lib(asrc / "ssd.cu", out_dir / f"libssd_against{i}.so",
                       asrc, "ssd_kernel_bf16")
        alt.ssd_scan.argtypes = [_P] * 7 + [_I] * 7 + [_L] * 7 + [_P, _U,
                                                                   _P]
        alt.ssd_scan.restype = _I
        against[tree.name] = alt

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    epoch = [1 << 20]   # the tool's own scratch and epochs
    for name, ((b, l, h, p, n), strided) in SHAPES.items():
        x, dt, a, bm, cm, d = inputs(b, l, h, p, n, strided, gen, dev)
        want = ref.ssd_chunked(x, dt, a, bm, cm, d,
                               chunk=min(128, max(l, 8))).float()
        y = torch.empty((b, l, h, p), dtype=torch.bfloat16, device=dev)
        scratch = torch.zeros(ops.scratch_bytes(b, h, p, n),
                              dtype=torch.uint8, device=dev)
        xs, bs, cs = (ops.tma_strides(t) for t in (x, bm, cm))

        def variant(g, wgs, st, minb):
            def call():
                epoch[0] += 1
                err = lib.ssd_variant(
                    x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                    cm.data_ptr(), d.data_ptr(), y.data_ptr(), b, l, h, p, n,
                    *xs, *bs, *cs, scratch.data_ptr(), epoch[0], g, wgs, st,
                    minb, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError_t {err}")
            return call

        def checked(call) -> dict:
            y.zero_()
            call()
            torch.cuda.synchronize()
            err = (y.float() - want).abs()
            ok = bool((err <= ATOL + RTOL * want.abs()).all()
                      and torch.isfinite(y).all())
            return {"max_abs_err": err.max().item(), "ok": ok}

        rec = {"shape": name, "b_l_h_p_n": [b, l, h, p, n],
               "strided": strided}
        port = lambda: ops.ssd(x, dt, a, bm, cm, d)  # noqa: E731
        got = port()
        torch.cuda.synchronize()
        rec["port_err"] = (got.float() - want).abs().max().item()
        rec["port_repeat_bit_equal"] = bool(torch.equal(got, port()))
        par = None
        if parent is not None and not strided:
            def par():
                err = parent.ssd_scan(
                    x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                    cm.data_ptr(), d.data_ptr(), y.data_ptr(), b, l, h, p, n,
                    1, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError_t {err}")
            rec["parent"] = checked(par)
        fns = {"parent": par, "port": port}
        for name_, alt in against.items():
            ascr = torch.zeros(ops.scratch_bytes(b, h, p, n),
                               dtype=torch.uint8, device=dev)

            def alt_call(alt=alt, ascr=ascr):
                epoch[0] += 1
                err = alt.ssd_scan(
                    x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                    cm.data_ptr(), d.data_ptr(), y.data_ptr(), b, l, h, p, n,
                    1, ops.plan(p, n, x.dtype)["na"], *xs, *bs, *cs,
                    ascr.data_ptr(), epoch[0],
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError_t {err}")
            fns[name_] = alt_call
            rec[name_] = checked(alt_call)
        order = [k for k, v in fns.items() if v]
        turns = {k: [] for k in order}
        for who in order + order[::-1]:
            turns[who].append(device_ms(fns[who]))
        rec.update({f"{k}_ms": v for k, v in turns.items()})
        for who in order:
            rec[f"{who}_kernel_ms"] = kernel_ms(fns[who])
        rec["plain_ms"] = device_ms(
            lambda: ref.ssd_chunked(x, dt, a, bm, cm, d, chunk=128), calls=3,
            runs=3)
        if args.trace:
            for grp in (2, 1):
                rec[f"trace_g{grp}"] = traced(
                    lib, x, dt, a, bm, cm, d, y, scratch, (b, l, h, p, n),
                    (xs, bs, cs), epoch, grp)
        rec["variants"] = []
        for g, wgs, st, minb in variants:
            row = {"g": g, "wgs": wgs, "stages": st, "minb": minb}
            call = variant(g, wgs, st, minb)
            try:
                row.update(checked(call))
                row.update(ms=device_ms(call), kernel_ms=kernel_ms(call))
            except RuntimeError as e:
                row["error"] = str(e)
            rec["variants"].append(row)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if args.prefill:
        runs = [ROOT / "src"] + ([args.parent / "src"] if args.parent
                                 else [])
        for src in runs:
            out = subprocess.run(
                [sys.executable, __file__, "--prefill-only", str(src)],
                capture_output=True, text=True, timeout=900)
            line = (out.stdout.strip().splitlines() or [""])[-1]
            rec = {"prefill_profile": json.loads(line) if out.returncode == 0
                   else {"src": str(src), "error": out.stderr[-2000:]}}
            results.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "shapes": results},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
