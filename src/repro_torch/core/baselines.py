"""Periodicity-detection baselines the paper compares against (Table
II), the torch counterpart of `repro.core.baselines`.

FFT: [Cortez et al., SOSP'17] assume a workload is user-facing if the FFT
shows a 24-hour period. ACF: autocorrelation at the 24-hour lag.

Both baselines get the same preprocessing as the template algorithm
(de-trend and normalize, `core.timeseries.preprocess`) and the same
machine-generated disambiguation (the 24h signal against the 8h/12h
harmonics). Each returns a continuous user-facing score, so Table II can
sweep a threshold to a recall target and report the precision there
(`precision_at_recall`, host numpy). These are not hand-written kernels:
the spectrum is `torch.fft.rfft` on the series' device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import timeseries as ts
from repro_torch.core.criticality import PERIOD_8H, PERIOD_12H, PERIOD_24H
from repro_torch.device import resolve_device

_EPS = 1e-9


def _series(series, device) -> torch.Tensor:
    return torch.as_tensor(series, dtype=torch.float32,
                           device=resolve_device(device))


def fft_score(series, device=None) -> torch.Tensor:
    """Higher = more user-facing. (B, T) -> (B,) on `device` (the card
    unless ``device="cpu"``); T must be a multiple of 48.

    Power at the 24h frequency less the stronger 8h/12h harmonic, over
    the total energy without the mean."""
    x = ts.preprocess(_series(series, device))
    x = x - x.mean(-1, keepdim=True)
    t = x.shape[-1]
    spec = torch.abs(torch.fft.rfft(x, dim=-1)) ** 2         # (B, T//2+1)
    p24 = spec[..., t // PERIOD_24H]      # cycles of each period in the
    p12 = spec[..., t // PERIOD_12H]      # window
    p8 = spec[..., t // PERIOD_8H]
    total = spec[..., 1:].sum(-1)
    return (p24 - torch.maximum(p12, p8)) / torch.clamp(total, min=_EPS)


def _acf_at(x: torch.Tensor, lag: int) -> torch.Tensor:
    a = x[..., :-lag]
    b = x[..., lag:]
    a = a - a.mean(-1, keepdim=True)
    b = b - b.mean(-1, keepdim=True)
    num = (a * b).sum(-1)
    den = torch.sqrt((a * a).sum(-1) * (b * b).sum(-1))
    return num / torch.clamp(den, min=_EPS)


def acf_score(series, device=None) -> torch.Tensor:
    """Higher = more user-facing. Autocorrelation at the 24h lag less the
    stronger of the 8h/12h lags (the same disambiguation as
    `fft_score`)."""
    x = ts.preprocess(_series(series, device))
    r24 = _acf_at(x, PERIOD_24H)
    r12 = _acf_at(x, PERIOD_12H)
    r8 = _acf_at(x, PERIOD_8H)
    return r24 - torch.maximum(r12, r8)


def precision_at_recall(scores, labels, recall_target: float):
    """Sweep a threshold on `scores` (higher = predicted UF) to reach
    `recall_target` on the true-UF class; returns (precision, recall,
    threshold). Host numpy."""
    if torch.is_tensor(scores):
        scores = scores.cpu().numpy()
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=bool)
    order = np.argsort(-scores)               # descending score
    sorted_labels = labels[order]
    tp = np.cumsum(sorted_labels)
    fp = np.cumsum(~sorted_labels)
    n_pos = max(int(labels.sum()), 1)
    recall = tp / n_pos
    precision = tp / np.maximum(tp + fp, 1)
    ok = np.nonzero(recall >= recall_target)[0]
    if len(ok) == 0:
        return 0.0, float(recall[-1]), float(scores[order][-1])
    i = ok[0]
    return float(precision[i]), float(recall[i]), float(scores[order][i])
