"""The batch prefill entry: `repro_torch.launch.steps.make_prefill_step`
on batches of same-length prompts, one batch in flight (a closed loop
with one client). A request's first token is the argmax of its
last-token logits, copied to the host; its time to first token runs
from its batch's issue to that copy.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.launch.steps import make_prefill_step

#: The expert capacity the prefill path applies (`transformer._block_apply`
#: runs the MoE at capacity factor 1.25); the reference applies the same.
CAPACITY_FACTOR = 1.25


class Entry:
    kind = "prefill"
    capacity_factor = CAPACITY_FACTOR

    def __init__(self, cfg, params, traffic, rng: np.random.Generator,
                 device):
        self.cfg, self.params, self.device = cfg, params, device
        self.batch = int(traffic["batch"])
        self.lengths = [int(n) for n in traffic["lengths"]]
        self.check = {int(k): int(v)
                      for k, v in traffic["check"]["batches"].items()}
        if max(self.lengths) not in self.check:
            raise ValueError("the check must sample the longest prompts")
        self.rng = rng
        self.step = make_prefill_step(cfg, impl=traffic["impl"])

    def _run(self, prompts: np.ndarray) -> np.ndarray:
        logits = self.step(self.params, {"tokens": torch.as_tensor(
            prompts, device=self.device)})
        return logits.argmax(-1).cpu().numpy()

    def warm(self, rng: np.random.Generator) -> None:
        """One batch of each length the traffic sends, longest first."""
        for n in sorted(set(self.lengths), reverse=True):
            self._run(rng.integers(0, self.cfg.vocab_size,
                                   (self.batch, n)))

    def issue(self, i: int) -> dict:
        n = self.lengths[i % len(self.lengths)]
        prompts = self.rng.integers(0, self.cfg.vocab_size, (self.batch, n))
        t0 = time.perf_counter()
        served = self._run(prompts)
        t1 = time.perf_counter()
        return {"kind": self.kind, "index": i, "batch": self.batch,
                "length": n, "generated": 1, "steps": 1, "t0": t0,
                "t1": t1, "prompts": prompts, "served": served[:, None]}

    def release(self) -> None:
        self.step = None

    def check_inputs(self, records, rng: np.random.Generator):
        """(token batches, positions read, served tokens): whole batches
        drawn from the seed, as many of each length as the traffic's
        `check` names, since a batch's prompts share the experts'
        capacity."""
        batches, reads, served = [], [], []
        for n, count in sorted(self.check.items()):
            pool = [r for r in records if r["length"] == n]
            for j in sorted(rng.choice(len(pool), min(count, len(pool)),
                                       replace=False)):
                r = pool[j]
                batches.append(torch.as_tensor(r["prompts"],
                                               device=self.device))
                reads.append(torch.tensor([n - 1], device=self.device))
                served.append(r["served"])
        return batches, reads, served
