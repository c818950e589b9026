#!/usr/bin/env python3
"""Time the bf16 flash-attention kernel's tilings on one NVIDIA card.

    python tools/flash_variants.py [--parent DIR] [--out FILE]

Builds `tools/flash_variants.cu` (the kernel template of
`src/repro_torch/csrc/flash_attention.cu` at the tilings it lists) with
the port's nvcc flags, and at the three shapes the flash kernel is held
to (Zamba2's prefill 8 x 32 heads x 512 at D 80, one 4,096-token prompt
of those heads, mixtral-8x22b's 8 x 48 query heads over 8 kv heads x
512 at D 128, all causal) checks each tiling against the plain version
at the bf16 bar and times it: device ms a call, the median of 7 runs of
20 back-to-back calls between CUDA events (`ms`), and the kernels' own
device time a call from torch.profiler (`kernel_ms`). Beside them, in turns, it
times the port's wrapper (the library's own tiling), SDPA and, with
`--parent DIR` (a checkout of an earlier commit, e.g. unpacked by `git
archive`), that commit's flash kernel built from its sources. One JSON
line per shape; the card's name and power limit first. Needs a card and
the CUDA toolkit; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: name -> (B, Hq, Hkv, L, D), causal
SHAPES = {"prefill": (8, 32, 32, 512, 80), "long": (1, 32, 32, 4096, 80),
          "mixtral": (8, 48, 8, 512, 128)}
ATOL = 2e-2
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRY = [_P] * 4 + [_I] * 10 + [_F]


def nvcc_lib(src: Path, out: Path, include: Path,
             kernel: str = "flash_kernel_bf16") -> ctypes.CDLL:
    """`src` compiled and linked alone into `out` with the port's flags;
    prints ptxas's registers, shared memory and spills for each function
    whose name holds `kernel`, and its performance advisories."""
    from repro_torch.kernels import build
    out.parent.mkdir(parents=True, exist_ok=True)
    log = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                          str(include), "-shared", str(src), "-o", str(out)],
                         check=True, capture_output=True, text=True)
    text = log.stdout + log.stderr
    fn, regs = None, {}
    for ln in text.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
        elif fn and kernel in fn and ("spill" in ln or "registers" in ln):
            regs[fn] = (regs.get(fn, "") + " " + ln.split(":")[-1].strip())
    notes = sorted({re.sub(r"around line \d+ ", "", ln.strip())
                    for ln in text.splitlines() if "(C75" in ln})
    print(json.dumps({"library": out.name, "ptxas": regs,
                      "advisories": notes}), flush=True)
    return ctypes.CDLL(str(out))


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
    torch.profiler over `calls` calls: the kernels' own time, whatever
    the host spends around them."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import ops, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    out_dir = ROOT / "build" / "flash_variants"
    lib = nvcc_lib(ROOT / "tools" / "flash_variants.cu",
                   out_dir / "libflash_variants.so", csrc)
    lib.flash_variant.argtypes = ENTRY + [_I] * 5 + [_P]
    lib.flash_variant.restype = _I
    rows = (ctypes.c_int * 500)()
    n = lib.flash_variant_list(rows, 100)
    variants = [tuple(rows[5 * i:5 * i + 5]) for i in range(n)]
    parent = None
    if args.parent is not None:
        psrc = args.parent / "src" / "repro_torch" / "csrc"
        parent = nvcc_lib(psrc / "flash_attention.cu",
                          out_dir / "libflash_parent.so", psrc)
        parent.flash_attention.argtypes = ENTRY + [_I, _P]
        parent.flash_attention.restype = _I

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    for name, (b, hq, hkv, l, d) in SHAPES.items():
        q = torch.randn((b, hq, l, d), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, hkv, l, d), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        rep = hq // hkv
        want = ref.attention_ref(q, k.repeat_interleave(rep, 1),
                                 v.repeat_interleave(rep, 1), causal=True)
        o = torch.empty_like(q)

        def entry(fn, *extra):
            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), b * hq, hq, rep, l, l, d, 0, l, 1, 0,
                         d ** -0.5, *extra,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError_t {err}")
            return call

        def checked(call) -> float:
            o.zero_()
            call()
            torch.cuda.synchronize()
            return (o.float() - want.float()).abs().max().item()

        rec = {"shape": name, "b_hq_hkv_l_d": [b, hq, hkv, l, d]}
        port = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa
            q, k, v, is_causal=True, enable_gqa=rep > 1)
        par = entry(parent.flash_attention, 1) if parent else None
        try:
            rec["port_err"] = (port().float()
                               - want.float()).abs().max().item()
        except RuntimeError as e:   # recorded; the tilings still run
            rec["port_error"], port = str(e), None
        if par:
            rec["parent_err"] = checked(par)
        turns = {"parent": [], "port": [], "sdpa": []}
        for who in ("parent", "port", "sdpa", "sdpa", "port", "parent"):
            fn = {"parent": par, "port": port, "sdpa": sdpa}[who]
            if fn:
                turns[who].append(device_ms(fn))
        rec.update({f"{k}_ms": v for k, v in turns.items() if v})
        for who, fn in (("parent", par), ("port", port), ("sdpa", sdpa)):
            if fn:
                rec[f"{who}_kernel_ms"] = kernel_ms(fn)
        rec["variants"] = []
        for dp, wgs, bk, st, minb in variants:
            if dp < d:
                continue
            row = {"dp": dp, "wgs": wgs, "bk": bk, "stages": st,
                   "minb": minb}
            call = entry(lib.flash_variant, dp, wgs, bk, st, minb)
            try:
                err = checked(call)
                row.update(max_abs_err=err, ok=err <= ATOL,
                           ms=device_ms(call), kernel_ms=kernel_ms(call))
            except RuntimeError as e:
                row["error"] = str(e)
            rec["variants"].append(row)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "shapes": results},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
