"""Training launcher, as `repro.launch.train` has it: real steps on the
card (or the CPU when asked) through the whole training stack — a
config-driven model with seeded weights, the configured optimizer, the
synthetic data pipeline with prefetch, the fault-tolerant loop with
checkpoint/restart, and optionally the paper's power control plane
governing the job.

Usage (on the card unless --device says otherwise):
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
      --reduced --steps 200 --batch 8 --seq 128 [--power-capped] \
      [--device cpu]

Against the reference, by design: the step writes into the old state
(the reference jits it with `donate_argnums`); a step waits for the card
before it returns (it reads the loss), so the loop's step times and the
throttle's stretch are the step's, not its launches'; and a rewind
replays the rewound steps' own batches (`SyntheticLM.batch_at(step)`),
where the reference takes the prefetcher's next batch, so that a run
with failures ends in the state of a run without.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim import get_optimizer
from repro_torch.runtime.fault_tolerance import (FaultToleranceConfig,
                                                 FaultTolerantLoop)
from repro_torch.runtime.power_control import (ChassisPowerSim, JobSpec,
                                               ThrottledLoop)


def add_run_args(ap, steps: int, batch: int, seq: int, lr: float,
                 ckpt_dir: str) -> None:
    """The flags `run` reads, with the caller's defaults."""
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--seq", type=int, default=seq)
    ap.add_argument("--lr", type=float, default=lr)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), ckpt_dir))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failures", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")


def run(cfg, args, dev, throttle=None, trace=None):
    """Train `cfg` for `args.steps` steps on `dev` under the
    fault-tolerant loop; the step runs under `throttle` (a
    `ThrottledLoop`) when given. Returns (losses, history, loop): the
    loss of every step taken, replays included, each step's metrics
    ({"loss", "grad_norm", "step"}, plus the throttle's "freq" and
    "step_s"), and the loop with its run state.

    `trace`, when a dict, receives the final `state` ({"params",
    "opt_state"}), the `step_fn` the loop ran, the data `source`, the
    `history` and the `loop`."""
    params = T.init_params(cfg, args.seed, device=dev)
    opt_state = get_optimizer(cfg.optimizer).init(params)
    state = {"params": params, "opt_state": opt_state}
    del params, opt_state     # the loop owns the state; a restore replaces it
    step = make_train_step(cfg, impl="naive", lr=args.lr, donate=True)

    def synced(p, o, b):
        p, o, metrics = step(p, o, b)
        # reading the metrics waits for the step on the card
        return p, o, {k: float(v) for k, v in metrics.items()}

    source = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                    seed=args.seed))
    feed = [Prefetcher(source)]

    def batch_fn(n):
        got, batch = feed[0].next()
        if got != n:                   # a rewind: replay step n's batch
            feed[0].close()
            feed[0] = Prefetcher(source, start_step=n)
            got, batch = feed[0].next()
        return got, batch

    def step_fn(state, batch):
        n, arrays = batch
        b = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
        if throttle is not None:
            (p, o, metrics), pw = throttle.run_step(
                synced, state["params"], state["opt_state"], b)
            metrics = dict(metrics, **pw)
        else:
            p, o, metrics = synced(state["params"], state["opt_state"], b)
        return {"params": p, "opt_state": o}, dict(metrics, step=n)

    ft = FaultTolerantLoop(
        FaultToleranceConfig(checkpoint_every=args.ckpt_every,
                             inject_failure_rate=args.inject_failures),
        Checkpointer(args.ckpt_dir, keep_last=2), rng_seed=args.seed)
    try:
        state, history = ft.run(state, step_fn, batch_fn, args.steps)
    finally:
        feed[0].close()
    if trace is not None:
        trace.update(state=state, step_fn=step_fn, source=source,
                     history=history, loop=ft)
    return [h["loss"] for h in history], history, ft


def main(argv=None, trace=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    add_run_args(ap, steps=100, batch=8, seq=128, lr=3e-4,
                 ckpt_dir="repro_torch_ckpt")
    ap.add_argument("--power-capped", action="store_true",
                    help="run under the paper's per-VM capping controller")
    ap.add_argument("--chassis-budget", type=float, default=2450.0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"[train] {cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"opt={cfg.optimizer} on {dev}")

    throttle = None
    if args.power_capped:
        chassis = ChassisPowerSim(budget_w=args.chassis_budget, device=dev)
        # this training job is batch (non-user-facing); a co-hosted
        # user-facing serving job shares the chassis
        chassis.register(JobSpec("serve-frontend", cores=120,
                                 user_facing=True, p95_util=0.65))
        chassis.register(JobSpec("this-train-job", cores=360,
                                 user_facing=False, p95_util=0.95))
        throttle = ThrottledLoop(chassis, "this-train-job")
        print("[train] power control: non-user-facing job under chassis "
              f"budget {args.chassis_budget:.0f} W")

    t0 = time.time()
    losses, _, ft = run(cfg, args, dev, throttle, trace)
    dt = time.time() - t0
    print(f"[train] {len(losses)} steps in {dt:.1f}s "
          f"({dt/max(len(losses),1)*1e3:.0f} ms/step) "
          f"loss {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f} "
          f"restarts={ft.state.restarts}")
    return losses


if __name__ == "__main__":
    main()
