"""Serving scenario, the twin of `examples/serve_capped.py`: a
user-facing LM serving job and a batch training job share a chassis
under an oversubscribed power budget. The per-VM capping controller
(paper §III-D) throttles only the batch job; the serving job's decode
latency stays flat.

    PYTHONPATH=src python -m repro_torch.examples.serve_capped [--device cpu]

The serve job reads `params` while the train job advances its own
`t_params`: the train step is functional (no donation), so the serving
weights never move. Each job's step reads its result to the host before
it returns, so `ThrottledLoop` times the step, not its launches.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step, make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim import get_optimizer
from repro_torch.runtime.power_control import (ChassisPowerSim, JobSpec,
                                               ThrottledLoop)


def main(device=None) -> dict:
    """Run the scenario on `device` (the card unless ``device="cpu"``),
    print its lines and return its numbers: the serve job's frequency,
    the train job's lowest, the p95 decode latency in ms and the train
    losses. Raises unless only the train job was throttled."""
    dev = resolve_device(device)
    cfg = get_config("phi4-mini-3.8b").reduced()
    params = T.init_params(cfg, 0, device=dev)

    # chassis with a serving job (user-facing) + training job (batch)
    chassis = ChassisPowerSim(budget_w=245.0, device=dev)
    chassis.register(JobSpec("serve", cores=16, user_facing=True,
                             p95_util=0.7))
    chassis.register(JobSpec("train", cores=24, user_facing=False,
                             p95_util=1.0))
    serve_loop = ThrottledLoop(chassis, "serve", utilization=0.7)
    train_loop = ThrottledLoop(chassis, "train")

    serve_step = make_serve_step(cfg)
    train_step = make_train_step(cfg, impl="naive", lr=1e-3)

    def serve(p, cache, batch):
        logits, cache = serve_step(p, cache, batch)
        return logits.argmax(-1)[:, None].cpu(), cache

    def train(p, o, batch):
        p, o, m = train_step(p, o, batch)
        return p, o, {k: float(v) for k, v in m.items()}

    opt_state = get_optimizer(cfg.optimizer).init(params)
    B, S = 4, 48
    cache = T.init_cache(cfg, B, S, device=dev)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)),
                             device=dev)
    batch = {"tokens": torch.as_tensor(
                 rng.integers(0, cfg.vocab_size, (2, 32)), device=dev),
             "labels": torch.as_tensor(
                 rng.integers(0, cfg.vocab_size, (2, 32)), device=dev)}

    serve_lat, train_freqs, losses = [], [], []
    t_params, t_opt = params, opt_state
    for i in range(32):
        # interleave: one decode step (user-facing) + one train step
        t0 = time.time()
        (nxt, cache), _ = serve_loop.run_step(
            serve, params, cache, {"tokens": tokens, "cache_index": i})
        serve_lat.append(time.time() - t0)
        (t_params, t_opt, m), m_t = train_loop.run_step(
            train, t_params, t_opt, batch)
        train_freqs.append(m_t["freq"])
        losses.append(m["loss"])
        tokens = nxt.to(dev)

    out = {"serve_freq": chassis.job_frequency("serve"),
           "train_min_freq": min(train_freqs),
           "p95_decode_ms": float(np.percentile(serve_lat, 95) * 1e3),
           "losses": losses}
    print("[serve_capped] chassis budget 245 W")
    print(f"  serve (user-facing): freq stayed at {out['serve_freq']:.2f}, "
          f"p95 decode latency {out['p95_decode_ms']:.0f} ms")
    print(f"  train (batch): throttled to min freq "
          f"{out['train_min_freq']:.2f} under the budget")
    if out["serve_freq"] != 1.0 or not out["train_min_freq"] < 1.0:
        raise RuntimeError(f"only the batch job may be throttled: {out}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
