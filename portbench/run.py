"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `src/repro_torch`, on a machine
with as many CUDA cards as the cell asks for. The last line of standard
output is the result (JSON); the last lines of standard error are the
numbers `correct` compared, each beside its limit. Exits nonzero, with
no result, when the cards are missing, when the process holds JAX or
the JAX package after the window, or on any error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # one host thread drives the card: no CPU pool of the process's own
    # competes with it for the host's shared cores
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    from portbench.harness import Bench, ForbiddenModules, run_cell
    torch.set_num_threads(1)
    chips = int(Bench(ROOT).cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        line = run_cell(ROOT, args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", T_START)
    except ForbiddenModules as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 3
    for name, v in line["checks"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
