#!/usr/bin/env python3
"""Time this tree's flash and SSD kernels against another tree's, in
turns, on one NVIDIA card.

    python tools/kernel_ab.py --parent DIR [--turns 2] [--out FILE]

DIR is a checkout of another commit (e.g. unpacked by `git archive`).
Each tree runs in a process of its own, its `src` first on the path and
its library built from its own sources, in turns (parent, this, this,
parent, ...), at the shapes the LM path gives the kernels, bf16: flash
at Zamba2's prefill (8 x 32 heads x 512, D 80, causal), one 4,096-token
prompt and mixtral's heads (8 x 48 over 8 kv heads x 512, D 128); SSD
at Zamba2's prefill (8 x 512, 80 heads, P = N = 64), one 4,096-token
prompt, and N 128 (mamba2's state). Each time is device ms a call: the
median of 7 runs of 20 back-to-back calls between CUDA events. Every
process also prints its library's ptxas lines for the two bf16 kernels
(registers, spills). One JSON line per process; the card's name and
power limit first. Needs a card and the CUDA toolkit; imports neither
JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from flash_variants import device_ms

ROOT = Path(__file__).resolve().parents[1]

#: name -> (B, Hq, Hkv, L, D), causal
FLASH = {"flash_prefill": (8, 32, 32, 512, 80),
         "flash_long": (1, 32, 32, 4096, 80),
         "flash_mixtral": (8, 48, 8, 512, 128)}
#: name -> (B, L, H, P, N)
SSD = {"ssd_prefill": (8, 512, 80, 64, 64),
       "ssd_long": (1, 4096, 80, 64, 64),
       "ssd_n128": (8, 512, 80, 64, 128)}


def worker(src: Path) -> dict:
    """Device ms of each shape through the wrappers of the tree `src`."""
    sys.path.insert(0, str(src))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    info = build.build()
    ptxas, keep = [], False
    for ln in info["log"].splitlines():
        if "Compiling entry" in ln:
            keep = "flash_kernel_bf16" in ln or "ssd_kernel_bf16" in ln
        if keep:
            ptxas.append(ln.split(":", 1)[-1].strip()[:120])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"src": str(src), "ptxas": ptxas}
    for name, (b, hq, hkv, l, d) in FLASH.items():
        q = torch.randn((b, hq, l, d), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, hkv, l, d), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        out[name] = device_ms(lambda: fops.flash_attention(q, k, v))
    for name, (b, l, h, p, n) in SSD.items():
        x = torch.randn((b, l, h, p), generator=gen, device=dev).bfloat16()
        dt = torch.nn.functional.softplus(
            torch.randn((b, l, h), generator=gen, device=dev))
        a = -torch.linspace(1.0, 16.0, h, device=dev)
        bm, cm = (torch.randn((b, l, n), generator=gen,
                              device=dev).bfloat16() for _ in range(2))
        d = torch.ones(h, device=dev)
        out[name] = device_ms(lambda: sops.ssd(x, dt, a, bm, cm, d))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--turns", type=int, default=2,
                    help="pairs of (parent, this) runs, mirrored")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)  # a tree's src, in a subprocess
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines = [json.dumps({"card": smi})]
    print(lines[0], flush=True)
    trees = {"parent": args.parent.resolve() / "src", "this": ROOT / "src"}
    order = []
    for t in range(args.turns):
        order += ["parent", "this"] if t % 2 == 0 else ["this", "parent"]
    for who in order:
        run = subprocess.run(
            [sys.executable, __file__, "--parent", str(args.parent),
             "--worker", str(trees[who])], capture_output=True, text=True,
            check=True)
        rec = {"tree": who, **json.loads(run.stdout.strip().splitlines()[-1])}
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    if args.out:
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
