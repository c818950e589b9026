"""Plain torch version of the oblivious-forest kernel: the stacked gather,
compare and take of `repro.serve.inference._proba4_ref_stacked`, over a
stack of equally shaped forests.

Mirrors `repro_torch.core.forest.ObliviousForest.leaf_index_np`: a leaf
index packs the compare bits MSB-first (level l weighs 2^(D-1-l)).
`forest_predict_ref` is the reference's oracle of the same name: one
forest's leaf sums, normalized to class probabilities.
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


def normalize_forest_output(summed: torch.Tensor, kind: str,
                            n_trees: int) -> torch.Tensor:
    """Summed leaf values -> class probabilities: RF mean / GB softmax.

    The RF divisor is a tensor on the operand's device: CUDA divides by a
    Python scalar as a multiply by its reciprocal, which can differ from
    the CPU's (and JAX's) correctly rounded division in the last bit."""
    if kind == "rf":
        return summed / summed.new_full((), float(n_trees))
    m = summed - summed.max(-1, keepdim=True).values
    e = torch.exp(m)
    return e / e.sum(-1, keepdim=True)


def forest_predict_ref(x, feat_idx, thresholds, leaf_values,
                       kind: str) -> torch.Tensor:
    """x: (B, F); feat_idx/thresholds: (T, D); leaf_values: (T, 2**D, K),
    tensors or arrays. Returns (B, K) class probabilities on x's device
    (the CPU for an array): the leaf values summed over the trees, then
    the RF mean or the GB softmax."""
    x = torch.as_tensor(x, dtype=torch.float32)
    dev = x.device
    fi, thr, leaf = (torch.as_tensor(a, device=dev) for a in
                     (feat_idx, thresholds, leaf_values))
    summed = forest_sums_ref(x, fi[None].long(), thr[None].float(),
                             leaf[None].float())[:, 0]
    return normalize_forest_output(summed, kind, fi.shape[0])


def forest_sums_lanes(x: torch.Tensor, feat_idx: torch.Tensor,
                      thr: torch.Tensor, leaf: torch.Tensor,
                      tile: int | None = None,
                      lanes: int = 32) -> torch.Tensor:
    """`forest_sums_ref` in the CUDA kernel's summation order, float32
    add for add (tests only): per tree tile of `tile` trees (a multiple
    of 32; default one tile), lane j of a row's `lanes` sums its trees
    j, j + lanes, ... in order from 0; an xor butterfly combines the lane
    sums (lanes / 2 apart, then lanes / 4, ..., 1); tile sums add up in
    tile order."""
    b = x.shape[0]
    nf, t, _ = feat_idx.shape
    k = leaf.shape[3]
    idx = leaf_index_ref(x, feat_idx, thr)                     # (B, NF, T)
    fi = torch.arange(nf, device=x.device)[None, :, None]
    ti = torch.arange(t, device=x.device)[None, None, :]
    vals = leaf[fi, ti, idx]                                   # (B, NF, T, K)
    tile = tile or -(-t // 32) * 32
    out = None
    for t0 in range(0, t, tile):
        part = vals[:, :, t0:t0 + tile]
        acc = torch.zeros((b, nf, lanes, k), dtype=torch.float32,
                          device=x.device)
        for j in range(0, part.shape[2], lanes):
            chunk = part[:, :, j:j + lanes]
            acc[:, :, :chunk.shape[2]] += chunk
        half = lanes // 2
        while half:
            acc = acc[:, :, :half] + acc[:, :, half:2 * half]
            half //= 2
        s = acc[:, :, 0]
        out = s if out is None else out + s
    if out is None:
        return torch.zeros((b, nf, k), dtype=torch.float32, device=x.device)
    return out
