"""Time-series preprocessing for the criticality algorithm (paper §III-B),
the torch twin of `repro.core.timeseries`.

All functions are vectorized over a leading batch of VM series.
Series layout: (..., T) where T = days * slots_per_day (default 5 * 48 =
240 half-hour average CPU utilizations over 5 weekdays).
"""
from __future__ import annotations

import torch

SLOTS_PER_DAY = 48          # 30-minute intervals
DEFAULT_DAYS = 5
EPS = 1e-6


def rolling_day_mean(x: torch.Tensor,
                     window: int = SLOTS_PER_DAY) -> torch.Tensor:
    """Mean of the *previous* `window` samples at each position.

    For t < window we use the running prefix mean (the paper does not
    specify the warm-up; a prefix mean keeps the first day usable instead
    of discarding it). Shape-preserving.
    """
    t = x.shape[-1]
    csum = torch.cumsum(x, dim=-1)
    csum0 = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    idx = torch.arange(t, device=x.device)
    lo = torch.clamp(idx - window + 1, min=0)          # inclusive start
    width = (idx - lo + 1).to(x.dtype)
    win_sum = csum0[..., idx + 1] - csum0[..., lo]
    return win_sum / torch.clamp(width, min=1.0)


def detrend(x: torch.Tensor, window: int = SLOTS_PER_DAY) -> torch.Tensor:
    """Paper step 1a: scale each utilization by the mean of the previous
    24 hours, removing multi-day growth/decay trends."""
    return x / torch.clamp(rolling_day_mean(x, window), min=EPS)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Paper step 1b: divide by the (population) standard deviation of
    the whole series, as `jnp.std` computes it."""
    sd = torch.std(x, dim=-1, keepdim=True, correction=0)
    return x / torch.clamp(sd, min=EPS)


def preprocess(x: torch.Tensor, window: int = SLOTS_PER_DAY) -> torch.Tensor:
    """De-trend then normalize (paper §III-B step 1)."""
    return normalize(detrend(x, window))


def extract_template(x: torch.Tensor, period: int) -> torch.Tensor:
    """Paper step 2: per-slot 'typical' utilization = median across all
    repetitions of that slot. x: (..., T) with T % period == 0.
    Returns (..., period).

    Taken from a sort: `torch.median` returns the lower of the two
    middle values for an even count, where `jnp.median` averages them."""
    t = x.shape[-1]
    if t % period:
        raise ValueError(f"series length {t} is not a multiple of {period}")
    reps = t // period
    xs = torch.sort(x.reshape(x.shape[:-1] + (reps, period)), dim=-2).values
    if reps % 2:
        return xs[..., reps // 2, :]
    return (xs[..., reps // 2 - 1, :] + xs[..., reps // 2, :]) * 0.5


def template_deviation(x: torch.Tensor, period: int,
                       keep_frac: float = 0.8) -> torch.Tensor:
    """Paper step 3: overlay the template, compute |deviation| for every
    sample, exclude the (1-keep_frac) largest deviations, average the rest.
    Returns (...,) scalar per series."""
    t = x.shape[-1]
    reps = t // period
    template = extract_template(x, period)
    dev = torch.abs(x - template.repeat((1,) * (x.ndim - 1) + (reps,)))
    k = int(round(keep_frac * t))
    return torch.sort(dev, dim=-1).values[..., :k].mean(dim=-1)
