"""Batched two-stage inference (serve-pipeline stage 2), the torch
counterpart of `repro.serve.inference`.

One call evaluates all four forests of a trained `PredictionService`
(criticality, P95 stage 1, low- and high-bucket stage 2) on an arrival
micro-batch and applies the paper's confidence gate: low-confidence
queries fall back to the conservative user-facing @ bucket-3 answer the
production scheduler uses (§IV-B). When the four forests share one shape
(one hyperparameter set in `train_service`, the common case) they run as
one stack: a single launch of the forest kernel on the card. Operands
are packed once per model (`pack_service`), which keeps hot-swap cheap.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.core.predictor import CONFIDENCE_GATE, UF, PredictionService
from repro_torch.kernels.forest import ops, ref


class PackedForest(NamedTuple):
    feat_idx: torch.Tensor   # (..., T, D) int32 feature read at each level
    thr: torch.Tensor        # (..., T, D) float32
    leaf: torch.Tensor       # (..., T, 2**D, K) float32 leaf table


@dataclass(frozen=True)
class ForestMeta:
    n_trees: int
    depth: int
    kind: str


class PackedService(NamedTuple):
    """Device operands of the four forests, plus their (4, ...) stack when
    the four share one shape (else None)."""
    criticality: PackedForest
    stage1: PackedForest
    low: PackedForest
    high: PackedForest
    stacked: PackedForest | None


@dataclass(frozen=True)
class ServiceMeta:
    criticality: ForestMeta
    stage1: ForestMeta
    low: ForestMeta
    high: ForestMeta
    confidence_gate: float = CONFIDENCE_GATE
    n_features: int = 0


def pack_service(svc: PredictionService, device) \
        -> tuple[PackedService, ServiceMeta]:
    """Pack all four of a service's forests onto `device` — done once per
    (re)trained model — and check each, and their stack, as the kernel
    takes them (`forest.ops.check_stack`)."""
    forests = (svc.criticality, svc.p95.stage1, svc.p95.low, svc.p95.high)
    packed, metas = [], []
    for f in forests:
        fi, thr, leaf, t, d, kind = ops.pack_forest(f, device)
        packed.append(PackedForest(fi, thr, leaf))
        metas.append(ForestMeta(t, d, kind))
    stacked = None
    if len(set(metas)) == 1 and len({p.leaf.shape for p in packed}) == 1:
        stacked = PackedForest(*(torch.stack(a) for a in zip(*packed)))
        ops.check_stack(*stacked)
    for p in packed:
        ops.check_stack(*(a[None] for a in p))
    return (PackedService(*packed, stacked),
            ServiceMeta(*metas, confidence_gate=svc.confidence_gate,
                        n_features=svc.criticality.n_features))


def resolve_kernel(kernel: str, x: torch.Tensor) -> str:
    """'auto' -> 'cuda' (the hand-written kernel) for a tensor on the card
    and 'ref' (the plain version) for a tensor on the CPU, nothing else.
    'cuda' on a CPU tensor raises."""
    if kernel == "auto":
        return "cuda" if x.is_cuda else "ref"
    if kernel == "cuda":
        if not x.is_cuda:
            raise ValueError("kernel='cuda' needs a CUDA tensor, got one "
                             f"on {x.device}")
        return kernel
    raise ValueError(f"unknown kernel {kernel!r}: 'auto' or 'cuda'")


def served_query(packed: PackedService, meta: ServiceMeta, x: torch.Tensor,
                 kernel: str = "auto") -> dict:
    """x: (B, F) features -> the `PredictionService.query` dict as
    tensors, with the conservative fallback applied. Extra key
    `conservative` marks arrivals that hit either fallback."""
    if x.ndim != 2 or x.shape[1] != meta.n_features:
        raise ValueError(f"features {tuple(x.shape)} do not match the "
                         f"model's width {meta.n_features}")
    x = x.float().contiguous()
    if resolve_kernel(kernel, x) == "cuda":
        def sums(x, *stack):              # checked by pack_service
            return ops.forest_sums(x, *stack, checked=True)
    else:
        sums = ref.forest_sums_ref
    metas = (meta.criticality, meta.stage1, meta.low, meta.high)
    if packed.stacked is not None:
        summed = sums(x, *packed.stacked)                     # (B, 4, K)
        pc, p1, plo, phi = (
            ops.normalize_forest_output(summed[:, i], m.kind, m.n_trees)
            for i, m in enumerate(metas))
    else:
        pc, p1, plo, phi = (
            ops.normalize_forest_output(
                sums(x, *(a[None] for a in pf))[:, 0], m.kind, m.n_trees)
            for pf, m in zip(packed[:4], metas))

    wt, wt_conf = pc.argmax(-1), pc.max(-1).values
    s1 = p1.argmax(-1)
    bucket = torch.where(s1 == 1, phi.argmax(-1) + 2, plo.argmax(-1))
    pb_conf = torch.minimum(p1.max(-1).values,
                            torch.where(s1 == 1, phi.max(-1).values,
                                        plo.max(-1).values))
    gate = meta.confidence_gate
    return {"workload_type": wt, "workload_conf": wt_conf,
            "p95_bucket": bucket, "p95_conf": pb_conf,
            "workload_type_used": torch.where(wt_conf >= gate, wt, UF),
            "p95_bucket_used": torch.where(pb_conf >= gate, bucket, 3),
            "conservative": (wt_conf < gate) | (pb_conf < gate)}


def bucket_to_p95_torch(bucket: torch.Tensor) -> torch.Tensor:
    """Torch twin of `repro.serve.inference.bucket_to_p95_jnp` (bucket
    midpoint as a utilization fraction, float32). The divisor is a device
    tensor so the card divides exactly as the CPU and XLA do."""
    b = bucket.float() * 25.0 + 12.5
    return b / b.new_full((), 100.0)
