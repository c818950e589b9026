"""Wrapper of the criticality template kernel (`csrc/template.cu`).

A series on the CPU takes the plain version (`ref.py`); a series on the
card launches the kernel or raises — it never falls back.
"""
from __future__ import annotations

import torch

from repro_torch.device import KERNEL_LAUNCHES
from repro_torch.kernels import build
from repro_torch.kernels.template import ref

#: Longest series the kernel takes (slots): 32 registers a lane.
MAX_T = 1024
#: Share of the smallest deviations the template score averages.
KEEP_FRAC = 0.8


def criticality_scores(series: torch.Tensor) -> torch.Tensor:
    """(B, T) float32 utilization series, T a multiple of 48 -> (B, 2)
    [Compare8, Compare12]."""
    if series.ndim != 2 or series.shape[1] % 48 or series.shape[1] == 0:
        raise ValueError(f"series must be (B, T) with T a positive multiple "
                         f"of 48, got {tuple(series.shape)}")
    if series.device.type == "cpu":
        return ref.criticality_scores_ref(series)
    if series.device.type != "cuda":
        raise ValueError(f"no kernel for device {series.device}")
    if series.dtype != torch.float32 or not series.is_contiguous():
        raise ValueError("series must be contiguous float32")
    b, t = series.shape
    if t > MAX_T:
        raise ValueError(f"series of {t} slots exceed the kernel's {MAX_T}")
    out = torch.empty((b, 2), dtype=torch.float32, device=series.device)
    if b == 0:
        return out
    k = round(KEEP_FRAC * t)              # Python rounding, as the oracle
    n_pow2 = 1 << (t - 1).bit_length()    # 32 lanes x PER registers
    series = build.aligned(series)        # float4 row loads
    build.launch("criticality_scores", series, series.data_ptr(),
                 out.data_ptr(), b, t, n_pow2, k)
    KERNEL_LAUNCHES["template"] += 1
    return out
