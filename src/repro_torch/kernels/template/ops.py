"""Wrapper of the criticality template kernel (`csrc/template.cu`).

A series on the CPU takes the plain version (`ref.py`); a series on the
card launches the kernel or raises — it never falls back. The kernel has
two paths, picked by T: a warp a row with the row in registers up to
MAX_T slots, and a block a row with the row in shared memory up to
MAX_T_BLOCK.
"""
from __future__ import annotations

import torch

from repro_torch.device import KERNEL_LAUNCHES
from repro_torch.kernels import build
from repro_torch.kernels.template import ref

#: Longest series of the register path (slots): 32 registers a lane.
MAX_T = 1024
#: Shared memory a block may have on the H100 (227 KB), and the block
#: kernel's static arrays beside its buffer: the selection's three 256-bin
#: histograms (3,072 bytes; the medians' eight of 32 bins reuse them),
#: the 88 templates (352), the float64 and count reductions (192 + 96),
#: the three selections' state (48) and the 48 columns' least and largest
#: keys (384). `criticality_block_static_smem()` reads the compiled
#: kernel's figure.
SMEM_PER_BLOCK = 232448
BLOCK_STATIC_SMEM = 4144
#: Longest series the kernel takes (slots): whole days whose one buffer
#: (48 columns of R = T / 48 floats, R + 1 when R is even; 192 bytes a
#: repetition) fits beside the static arrays: R at most 1,189, so 57,072
#: slots (1,189 days).
MAX_T_BLOCK = 48 * (((SMEM_PER_BLOCK - BLOCK_STATIC_SMEM) // 192 - 1) | 1)
#: Share of the smallest deviations the template score averages, the
#: reference's default.
KEEP_FRAC = 0.8


def keep_count(t: int, keep_frac: float) -> int:
    """k = round(keep_frac * T) with Python's rounding, as the reference's
    kernel takes it; raises unless 1 <= k <= T (the mean of no deviation,
    or of more than T, is not a score)."""
    k = round(keep_frac * t)
    if not 1 <= k <= t:
        raise ValueError(f"keep_frac {keep_frac} keeps {k} of {t} slots: "
                         "it must keep between 1 and T")
    return k


def block_static_smem() -> int:
    """The compiled block kernel's static shared memory in bytes (needs
    the card); BLOCK_STATIC_SMEM must cover it."""
    n = build.load().criticality_block_static_smem()
    build.check(-n if n < 0 else 0, "criticality_block_static_smem")
    return n


def criticality_scores(series: torch.Tensor,
                       keep_frac: float = KEEP_FRAC) -> torch.Tensor:
    """(B, T) float32 utilization series, T a multiple of 48 -> (B, 2)
    [Compare8, Compare12], each template's deviation the mean of the
    round(keep_frac T) smallest."""
    if series.ndim != 2 or series.shape[1] % 48 or series.shape[1] == 0:
        raise ValueError(f"series must be (B, T) with T a positive multiple "
                         f"of 48, got {tuple(series.shape)}")
    b, t = series.shape
    k = keep_count(t, keep_frac)
    if series.device.type == "cpu":
        return ref.criticality_scores_ref(series, keep_frac)
    if series.device.type != "cuda":
        raise ValueError(f"no kernel for device {series.device}")
    if series.dtype != torch.float32 or not series.is_contiguous():
        raise ValueError("series must be contiguous float32")
    if t > MAX_T_BLOCK:
        raise ValueError(f"series of {t} slots exceed the kernel's "
                         f"{MAX_T_BLOCK}: a block holds the row in its "
                         "shared memory")
    out = torch.empty((b, 2), dtype=torch.float32, device=series.device)
    if b == 0:
        return out
    series = build.aligned(series)        # float4 row loads
    if t <= MAX_T:
        n_pow2 = 1 << (t - 1).bit_length()    # 32 lanes x PER registers
        build.launch("criticality_scores", series, series.data_ptr(),
                     out.data_ptr(), b, t, n_pow2, k)
    else:
        build.launch("criticality_scores_long", series, series.data_ptr(),
                     out.data_ptr(), b, t, k)
    KERNEL_LAUNCHES["template"] += 1
    return out
