"""Learning-rate schedules, as `repro.optim.schedule` has them."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    """step -> float32 learning rate: linear warm-up to `base_lr`, then a
    cosine down to `min_ratio * base_lr` at `total_steps`."""
    warm_n = torch.tensor(max(warmup_steps, 1), dtype=torch.float32)
    decay_n = torch.tensor(max(total_steps - warmup_steps, 1),
                           dtype=torch.float32)

    def lr_at(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / warm_n
        frac = torch.clamp((step - warmup_steps) / decay_n, 0.0, 1.0)
        # the reference's float32 cosine is rounded from the exact value;
        # torch's float32 cos can be an ulp off it, its float64 one is not
        c = torch.cos((math.pi * frac).double()).float()
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + c))
        return torch.where(step < warmup_steps, warm, cos)
    return lr_at
