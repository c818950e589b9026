"""Wrapper of the oblivious-forest kernel (`csrc/forest.cu`).

`pack_forest` turns a trained `ObliviousForest` into the kernel's
operands once per model (models retrain daily in the paper), and
`forest_predict` is the package's public call, features in and
probabilities out, as `repro.kernels.forest.forest_predict` is.
`forest_sums` runs a stack of equally shaped forests: the plain version
(`ref.py`) for a CPU tensor, the kernel for a CUDA tensor — it launches
or raises, it never falls back. Normalization (RF mean, GB softmax)
stays outside the kernel, as it stays outside the `pallas_call` in
`repro.kernels.forest`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.forest import ObliviousForest
from repro_torch.device import KERNEL_LAUNCHES, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.forest import ref
from repro_torch.kernels.forest.ref import normalize_forest_output

#: Warps per block of the kernel (`WARPS` in csrc/forest.cu).
WARPS = 4
#: 8-byte (index, threshold) words a block stages per tree tile: 32 KB.
NODE_WORDS = 4096
#: Feature-tile floats a block stages: 16 KB. With the node tile, the
#: kernel stays within the 48 KB of static shared memory.
X_FLOATS = 4096
#: Deepest tree: the kernel's leaf index is a 32-bit word. A (T, 2^32, K)
#: float32 leaf table would hold 16 GiB per tree and output.
MAX_DEPTH = 31
#: Streaming multiprocessors of an H100.
SMS = 132
#: Blocks the launch plan aims at: about 15 per SM.
TARGET_BLOCKS = 2048


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


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, f: int, nf: int, t: int, d: int, k: int) -> dict:
    """How the kernel runs a (B, F) batch through NF stacked forests of T
    trees at depth D with K outputs: the tree tile (a multiple of 32
    whose nodes fit NODE_WORDS), the lanes a row takes (8, 16 or 32: the
    fewest that still give the card two blocks per SM; 32 if none does),
    rows per block (a whole number of the warps' row steps, enough
    blocks to fill the card), the outputs per chunk `kc` and
    whether the feature tile is staged in shared memory. Raises only
    for a depth over MAX_DEPTH or more than 65,535 stacked forests (the
    grid's y limit); the Pallas kernel evaluates one forest a call."""
    if d > MAX_DEPTH:
        raise ValueError(f"depth {d} exceeds the kernel's {MAX_DEPTH}: its "
                         "leaf index is a 32-bit word")
    if nf > 65535:
        raise ValueError(f"{nf} stacked forests exceed the grid's 65,535")
    tile = min(-(-t // 32) * 32, NODE_WORDS // max(d, 1) // 32 * 32)
    stage_x = WARPS * f <= X_FLOATS
    kc = 1 if k == 1 else 2 if k == 2 else 4 if k <= 4 else 8
    for lanes in (8, 16, 32):  # fewer lanes a row: more rows a warp step
        step = WARPS * (32 // lanes)       # rows a block takes at a time
        rows = min(max(-(-b * nf // TARGET_BLOCKS), 1), 64)
        rows = -(-rows // step) * step
        if stage_x:
            rows = max(min(rows, X_FLOATS // f // step * step), step)
        if -(-b // rows) * nf >= 2 * SMS:
            break
    smem = tile * d * 8 + (rows * f * 4 if stage_x else 0)
    return {"rows": rows, "tile": tile, "lanes": lanes, "kc": kc,
            "stage_x": stage_x, "grid": (-(-b // rows), nf), "smem": smem}


def check_stack(feat_idx, thr, leaf) -> None:
    """Refuse a stack the kernel cannot take: shapes (NF, T, D), (NF, T,
    D), (NF, T, 2^D, K); int32 indices and float32 tables, contiguous, on
    one device; on the card the leaf table at a 16-byte boundary (its
    float2 / float4 reads). `inference.pack_service` checks each packed
    model once, so that a served micro-batch checks only its features."""
    if feat_idx.ndim != 3 or thr.shape != feat_idx.shape \
            or leaf.ndim != 4 or leaf.shape[:2] != feat_idx.shape[:2] \
            or leaf.shape[2] != 1 << feat_idx.shape[2]:
        raise ValueError(
            f"shapes feat_idx {tuple(feat_idx.shape)}, thr "
            f"{tuple(thr.shape)}, leaf {tuple(leaf.shape)} do not form a "
            "forest stack (NF,T,D), (NF,T,D), (NF,T,2^D,K)")
    if thr.device != feat_idx.device or leaf.device != feat_idx.device:
        raise ValueError("forest operands must share one device")
    if thr.dtype != torch.float32 or leaf.dtype != torch.float32 \
            or feat_idx.dtype != torch.int32:
        raise ValueError("thr/leaf must be float32 and feat_idx int32")
    if not (feat_idx.is_contiguous() and thr.is_contiguous()
            and leaf.is_contiguous()):
        raise ValueError("forest operands must be contiguous")
    if leaf.is_cuda and leaf.data_ptr() % 16:
        raise ValueError("the leaf table must start at a 16-byte boundary")


def forest_sums(x: torch.Tensor, feat_idx: torch.Tensor, thr: torch.Tensor,
                leaf: torch.Tensor, checked: bool = False) -> torch.Tensor:
    """x (B, F) float32; feat_idx (NF, T, D) int32 indexing x's columns;
    thr (NF, T, D) float32; leaf (NF, T, 2^D, K) float32 -> (B, NF, K)
    leaf values summed over each forest's trees. `checked`: the stack
    passed `check_stack` already (a packed model); x is checked always."""
    if not checked:
        if leaf.is_cuda:
            leaf = build.aligned(leaf)     # float2 / float4 leaf reads
        check_stack(feat_idx, thr, leaf)
    if x.ndim != 2 or x.device != feat_idx.device:
        raise ValueError(f"features {tuple(x.shape)} on {x.device} do not "
                         f"match a stack on {feat_idx.device}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no kernel for device {x.device}")
        return ref.forest_sums_ref(x, feat_idx, thr, leaf)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be contiguous float32")
    b, f = x.shape
    nf, t, d = feat_idx.shape
    k = leaf.shape[3]
    plan = launch_plan(b, f, nf, t, d, k)
    if b == 0 or nf == 0 or k == 0 or t == 0:
        return torch.zeros((b, nf, k), dtype=torch.float32, device=x.device)
    out = torch.empty((b, nf, k), dtype=torch.float32, device=x.device)
    build.launch("forest_sums", x, x.data_ptr(), feat_idx.data_ptr(),
                 thr.data_ptr(), leaf.data_ptr(), out.data_ptr(), b, f, nf,
                 t, d, k, plan["rows"], plan["tile"], plan["lanes"],
                 plan["kc"], int(plan["stage_x"]))
    KERNEL_LAUNCHES["forest"] += 1
    return out


def predict_packed(x, feat_idx, thr, leaf, kind: str) -> torch.Tensor:
    """(B, F) features through one packed forest (`pack_forest`'s
    operands) -> (B, K) probabilities."""
    summed = forest_sums(x.float().contiguous(), feat_idx[None], thr[None],
                         leaf[None])[:, 0]
    return normalize_forest_output(summed, kind, feat_idx.shape[0])


def forest_predict(forest: ObliviousForest, x, device=None) -> torch.Tensor:
    """(B, F) features -> (B, K) probabilities of a trained forest on
    `device` (None: the card): `pack_forest`, then the kernel's leaf sums
    (`forest_sums`; their plain version on the CPU), then the RF mean or
    the GB softmax. `x` is an array or a tensor."""
    dev = resolve_device(device)
    fi, thr, leaf, _, _, kind = pack_forest(forest, dev)
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        dtype=torch.float32, device=dev)
    return predict_packed(x, fi, thr, leaf, kind)
