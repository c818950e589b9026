"""Plain torch version of the criticality template kernel: the sort-based
oracle `repro_torch.core.criticality.score` (exact medians and exact
smallest-k selection by sorting), stacked to (B, 2)."""
from __future__ import annotations

import torch

from repro_torch.core import criticality


def criticality_scores_ref(series: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, 2) [Compare8, Compare12]."""
    s = criticality.score(series)
    return torch.stack([s.compare8, s.compare12], dim=-1)
