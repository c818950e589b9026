"""The greedy generation entry: `repro_torch.launch.serve.serve_batch`
on batches of same-length prompts, one batch in flight (a closed loop
with one client). Each batch feeds its prompts through the cache path a
token a step and then generates `generated` tokens a request.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.launch.serve import serve_batch
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as T

#: Decode is dropless (`transformer._block_decode`); the reference too.
CAPACITY_FACTOR = None


class Entry:
    kind = "decode"
    capacity_factor = CAPACITY_FACTOR

    def __init__(self, cfg, params, traffic, rng: np.random.Generator,
                 device):
        self.cfg, self.params, self.device = cfg, params, device
        self.batch = int(traffic["batch"])
        (self.length,) = (int(n) for n in traffic["lengths"])
        self.generated = int(traffic["generated"])
        self.impl = traffic["impl"]
        self.warm_steps = int(traffic["warm_steps"])
        self.check = int(traffic["check"]["requests"])
        self.rng = rng

    def warm(self, rng: np.random.Generator) -> None:
        """Decode steps at the cell's batch and cache length: every step
        of a batch has these shapes."""
        cache = T.init_cache(self.cfg, self.batch,
                             self.length + self.generated,
                             device=self.device)
        step = make_serve_step(self.cfg, impl=self.impl)
        tok = torch.as_tensor(rng.integers(0, self.cfg.vocab_size,
                                           (self.batch, 1)),
                              device=self.device)
        for i in range(self.warm_steps):
            logits, cache = step(self.params, cache,
                                 {"tokens": tok, "cache_index": i})
            tok = logits.argmax(-1)[:, None]
        tok.cpu()

    def issue(self, i: int) -> dict:
        prompts = self.rng.integers(0, self.cfg.vocab_size,
                                    (self.batch, self.length))
        t0 = time.perf_counter()
        served = serve_batch(self.cfg, self.params, prompts, self.generated,
                             impl=self.impl)
        t1 = time.perf_counter()
        return {"kind": self.kind, "index": i, "batch": self.batch,
                "length": self.length, "generated": self.generated,
                "steps": self.length + self.generated, "t0": t0, "t1": t1,
                "prompts": prompts, "served": np.asarray(served)}

    def release(self) -> None:
        pass

    def check_inputs(self, records, rng: np.random.Generator):
        """(token batches, positions read, served tokens): requests drawn
        from the seed over every finished batch, each its prompt with all
        but its last served token, read where each served token was
        chosen. Decode is dropless, so requests need not keep their
        batch."""
        pool = [(r, j) for r in records for j in range(r["batch"])]
        pick = sorted(rng.choice(len(pool), min(self.check, len(pool)),
                                 replace=False))
        rows = [np.concatenate([pool[k][0]["prompts"][pool[k][1]],
                                pool[k][0]["served"][pool[k][1], :-1]])
                for k in pick]
        served = np.stack([pool[k][0]["served"][pool[k][1]] for k in pick])
        read = torch.arange(self.length - 1, self.length + self.generated - 1,
                            device=self.device)
        return ([torch.as_tensor(np.stack(rows), device=self.device)],
                [read], [served])
