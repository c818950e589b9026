"""Criticality (user-facing vs non-user-facing) pattern-matching algorithm,
the torch twin of `repro.core.criticality`.

Paper §III-B, "Criticality algorithm": extract 24h/12h/8h median templates
from a VM's 5-weekday, 30-minute CPU-utilization series; a workload is
user-facing iff the 24h template fits *distinctly better* than the 8h
template: Compare8 = dev24/dev8 < threshold (0.72 in the paper, chosen in
Fig. 3 to put all manually-labeled important workloads left of the bar).

`score` is the sort-based oracle. `classify` and `classify_with_length`
take Compare8 from `repro_torch.kernels.template.ops.criticality_scores`:
the CUDA kernel for series on the card, the oracle for series on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import timeseries as ts
from repro_torch.device import resolve_device
from repro_torch.kernels.template import ops as template_ops

#: Fig. 3: vertical bar at Compare8 = 0.72 separates (clearly/possibly
#: user-facing) from (machine-generated / clearly non-user-facing).
COMPARE8_THRESHOLD = 0.72

#: Periods, in 30-minute slots: 24h, 12h, 8h. 12h/8h subsume the shorter
#: machine-generated periods (1h, 4h, 6h divide at least one of them).
PERIOD_24H = 48
PERIOD_12H = 24
PERIOD_8H = 16

#: "Shorter workloads cannot be classified and should be conservatively
#: assumed user-facing" — minimum series length (5 weekdays).
MIN_SAMPLES = 5 * ts.SLOTS_PER_DAY


class CriticalityScores(NamedTuple):
    compare8: torch.Tensor    # (B,) dev24/dev8  — the classifier signal
    compare12: torch.Tensor   # (B,) dev24/dev12 — reported for Fig. 3
    dev24: torch.Tensor
    dev12: torch.Tensor
    dev8: torch.Tensor

    def classify(self, threshold: float = COMPARE8_THRESHOLD) -> torch.Tensor:
        """True = user-facing (conservative direction)."""
        return self.compare8 < threshold


def score(series: torch.Tensor, keep_frac: float = 0.8) -> CriticalityScores:
    """Run the full pattern-matching algorithm on a batch of series.

    series: (B, T) average CPU utilization per 30-minute slot, T % 48 == 0.
    """
    x = ts.preprocess(series)
    dev24 = ts.template_deviation(x, PERIOD_24H, keep_frac)
    dev12 = ts.template_deviation(x, PERIOD_12H, keep_frac)
    dev8 = ts.template_deviation(x, PERIOD_8H, keep_frac)
    eps = 1e-6
    # If dev8 is ~0 the series fits an 8-hour template essentially exactly
    # (machine-generated or flat): the ratio must not classify it as UF.
    compare8 = dev24 / torch.clamp(dev8, min=eps)
    compare12 = dev24 / torch.clamp(dev12, min=eps)
    return CriticalityScores(compare8, compare12, dev24, dev12, dev8)


def classify(series, threshold: float = COMPARE8_THRESHOLD,
             device=None) -> torch.Tensor:
    """(B, T) -> (B,) bool user-facing labels, on `device` (the card
    unless ``device="cpu"``)."""
    x = torch.as_tensor(series, dtype=torch.float32,
                        device=resolve_device(device)).contiguous()
    return template_ops.criticality_scores(x)[:, 0] < threshold


def classify_with_length(series, n_valid,
                         threshold: float = COMPARE8_THRESHOLD,
                         device=None) -> torch.Tensor:
    """Length-aware classification: series shorter than MIN_SAMPLES are
    conservatively labeled user-facing (paper §III-B)."""
    uf = classify(series, threshold, device)
    n_valid = torch.as_tensor(n_valid, device=uf.device)
    return torch.where(n_valid < MIN_SAMPLES, True, uf)
