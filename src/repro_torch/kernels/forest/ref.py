"""Plain torch version of the oblivious-forest kernel: the stacked gather,
compare and take of `repro.serve.inference._proba4_ref_stacked`, over a
stack of equally shaped forests.

Mirrors `repro_torch.core.forest.ObliviousForest.leaf_index_np`: a leaf
index packs the compare bits MSB-first (level l weighs 2^(D-1-l)).
"""
from __future__ import annotations

import torch


def leaf_index_ref(x: torch.Tensor, feat_idx: torch.Tensor,
                   thr: torch.Tensor) -> torch.Tensor:
    """x (B, F); feat_idx/thr (NF, T, D) -> (B, NF, T) int64 leaf
    indices."""
    nf, t, d = feat_idx.shape
    gathered = x[:, feat_idx.reshape(-1).long()].reshape(-1, nf, t, d)
    bits = (gathered > thr[None]).long()
    weights = 2 ** torch.arange(d - 1, -1, -1, device=x.device)
    return (bits * weights).sum(-1)


def forest_sums_ref(x: torch.Tensor, feat_idx: torch.Tensor,
                    thr: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """x (B, F); feat_idx/thr (NF, T, D); leaf (NF, T, 2^D, K) ->
    (B, NF, K) leaf values summed over each forest's trees."""
    nf, t, _ = feat_idx.shape
    idx = leaf_index_ref(x, feat_idx, thr)                     # (B, NF, T)
    fi = torch.arange(nf, device=x.device)[None, :, None]
    ti = torch.arange(t, device=x.device)[None, None, :]
    return leaf[fi, ti, idx].sum(2)                            # (B, NF, K)
