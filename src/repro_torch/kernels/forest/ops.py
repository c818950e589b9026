"""Wrapper of the oblivious-forest kernel (`csrc/forest.cu`).

`pack_forest` turns a trained `ObliviousForest` into the kernel's
operands once per model (models retrain daily in the paper).
`forest_sums` runs a stack of equally shaped forests: the plain version
(`ref.py`) for a CPU tensor, the kernel for a CUDA tensor — it launches
or raises, it never falls back. Normalization (RF mean, GB softmax)
stays outside the kernel, as it stays outside the `pallas_call` in
`repro.kernels.forest`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.forest import ObliviousForest
from repro_torch.device import KERNEL_LAUNCHES
from repro_torch.kernels import build
from repro_torch.kernels.forest import ref

#: Most outputs per leaf the kernel accumulates in registers.
MAX_K = 8
#: Static shared-memory limit the kernel's staged tables must fit.
SMEM_LIMIT = 48 * 1024


def pack_forest(forest: ObliviousForest, device):
    """The kernel's operands for one forest on `device`: feat_idx (T, D)
    int32, thresholds (T, D) float32, leaf table (T, 2^D, K) float32,
    plus n_trees, depth and kind."""
    fi = np.asarray(forest.feat_idx)
    if fi.size and not (0 <= fi.min() and fi.max() < forest.n_features):
        raise ValueError("feat_idx indexes outside the forest's features")
    t, d = fi.shape
    return (torch.as_tensor(fi, dtype=torch.int32, device=device),
            torch.as_tensor(forest.thresholds, dtype=torch.float32,
                            device=device),
            torch.as_tensor(forest.leaf_values, dtype=torch.float32,
                            device=device).contiguous(),
            t, d, forest.kind)


def _check_stack(x, feat_idx, thr, leaf) -> None:
    if x.ndim != 2 or feat_idx.ndim != 3 or thr.shape != feat_idx.shape \
            or leaf.ndim != 4 or leaf.shape[:2] != feat_idx.shape[:2] \
            or leaf.shape[2] != 1 << feat_idx.shape[2]:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, feat_idx {tuple(feat_idx.shape)}, "
            f"thr {tuple(thr.shape)}, leaf {tuple(leaf.shape)} do not form "
            "a forest stack (B,F), (NF,T,D), (NF,T,D), (NF,T,2^D,K)")


def forest_sums(x: torch.Tensor, feat_idx: torch.Tensor, thr: torch.Tensor,
                leaf: torch.Tensor) -> torch.Tensor:
    """x (B, F) float32; feat_idx (NF, T, D) int32 indexing x's columns;
    thr (NF, T, D) float32; leaf (NF, T, 2^D, K) float32 -> (B, NF, K)
    leaf values summed over each forest's trees."""
    _check_stack(x, feat_idx, thr, leaf)
    if x.device.type == "cpu":
        return ref.forest_sums_ref(x, feat_idx, thr, leaf)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    ops = (x, feat_idx, thr, leaf)
    if any(a.device != x.device for a in ops):
        raise ValueError("forest operands must share x's device")
    if x.dtype != torch.float32 or thr.dtype != torch.float32 \
            or leaf.dtype != torch.float32 or feat_idx.dtype != torch.int32:
        raise ValueError("x/thr/leaf must be float32 and feat_idx int32")
    if not all(a.is_contiguous() for a in ops):
        raise ValueError("forest operands must be contiguous")
    b, f = x.shape
    nf, t, d = feat_idx.shape
    k = leaf.shape[3]
    smem = t * d * 8 + t * (1 << d) * k * 4
    if k > MAX_K or smem > SMEM_LIMIT:
        raise ValueError(f"forest of {t} trees, depth {d}, {k} outputs needs "
                         f"{smem} B of shared memory and {k} accumulators; "
                         f"the kernel takes {SMEM_LIMIT} B and {MAX_K}")
    out = torch.empty((b, nf, k), dtype=torch.float32, device=x.device)
    if b == 0 or nf == 0:
        return out
    with torch.cuda.device(x.device):
        err = build.load().forest_sums(
            x.data_ptr(), feat_idx.data_ptr(), thr.data_ptr(),
            leaf.data_ptr(), out.data_ptr(), b, f, nf, t, d, k,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "forest_sums")
    KERNEL_LAUNCHES["forest"] += 1
    return out


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


def predict_packed(x, feat_idx, thr, leaf, kind: str) -> torch.Tensor:
    """(B, F) features through one packed forest (`pack_forest`'s
    operands) -> (B, K) probabilities."""
    summed = forest_sums(x.float().contiguous(), feat_idx[None], thr[None],
                         leaf[None])[:, 0]
    return normalize_forest_output(summed, kind, feat_idx.shape[0])
