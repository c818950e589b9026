"""The readings `correct`'s limits are set from, on the card: for each
seed, a short window of the cell at its own load (long enough to finish
every length the check samples), then the gaps of the program's served
tokens against the reference; on the control seeds also those of the fp8
control's tokens at the same positions. One process for all seeds, each
with its own order of the shared weights and its own traffic.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 1,2,... [--control-seeds 1,2,...] [--out FILE]
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.harness import Bench, CellRun
    if not torch.cuda.is_available():
        print("portbench: calibrate needs a CUDA card", file=sys.stderr)
        return 2
    bench = Bench(ROOT)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    seeds += sorted(control - set(seeds))
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        run = CellRun(bench, args.workload, seed, "cuda")
        run.setup()
        run.window(args.seconds, False)
        got = run.check(control=seed in control)
        row = {"workload": args.workload, "seed": seed,
               "batches": len(run.records), "seconds":
               time.perf_counter() - t0, **got}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del run
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
