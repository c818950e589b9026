"""End-to-end training, the twin of `examples/train_lm.py`: train
a ~20M (or ~100M) parameter LM for a few hundred steps through the whole
training stack — data prefetch, AdamW, checkpoint/restart under the
fault-tolerant loop — optionally under the paper's power-capping control
plane (the job is tagged non-user-facing and gets throttled when the
chassis is tight).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
    ... --params-100m | --power-capped | --inject-failures 0.2

It runs `repro_torch.launch.train.run` on the demo config, so the flags
of that loop (--ckpt-every, --inject-failures, --seed) apply here too.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.train import add_run_args, run
from repro_torch.runtime.power_control import (ChassisPowerSim, JobSpec,
                                               ThrottledLoop)


def demo_config(params_100m: bool) -> ModelConfig:
    if params_100m:
        return ModelConfig(name="demo-100m", family="dense", n_layers=12,
                           d_model=768, n_heads=12, n_kv_heads=4,
                           d_ff=3072, vocab_size=32000, head_dim=64)
    return ModelConfig(name="demo-20m", family="dense", n_layers=6,
                       d_model=384, n_heads=6, n_kv_heads=2, d_ff=1536,
                       vocab_size=16000, head_dim=64)


def main(argv=None, trace=None):
    """Train the demo model as the flags say; prints progress every 50
    steps and returns the losses of the steps taken. Raises unless the
    loss fell, as the reference asserts."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_run_args(ap, steps=200, batch=2, seq=64, lr=1e-3,
                 ckpt_dir="repro_torch_example_ckpt")
    ap.add_argument("--params-100m", action="store_true")
    ap.add_argument("--power-capped", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = demo_config(args.params_100m)
    print(f"[train_lm] {cfg.name}: ~{cfg.param_count()/1e6:.0f}M params "
          f"on {dev}")
    throttle = None
    if args.power_capped:
        chassis = ChassisPowerSim(budget_w=250.0, device=dev)
        chassis.register(JobSpec("latency-svc", 12, True, 0.65))
        chassis.register(JobSpec("this-job", 28, False, 1.0))
        throttle = ThrottledLoop(chassis, "this-job")

    t0 = time.time()
    losses, history, ft = run(cfg, args, dev, throttle, trace)
    dt = time.time() - t0
    for i, h in enumerate(history):
        if (h["step"] + 1) % 50 == 0:
            msg = (f"[train_lm] step {h['step'] + 1}: loss "
                   f"{np.mean(losses[max(i - 19, 0):i + 1]):.3f}")
            if throttle is not None:
                msg += f" freq {h['freq']:.2f}"
            print(msg, flush=True)
    print(f"[train_lm] {len(losses)} steps in {dt:.0f}s "
          f"({dt/len(losses)*1e3:.0f} ms/step); "
          f"loss {losses[0]:.3f} -> {np.mean(losses[-20:]):.3f}; "
          f"restarts {ft.state.restarts}")
    if not np.mean(losses[-20:]) < losses[0]:
        raise RuntimeError("training must converge: loss "
                           f"{losses[0]:.3f} -> {np.mean(losses[-20:]):.3f}")
    return losses


if __name__ == "__main__":
    main()
