"""Wrapper of the flash-attention kernel (`csrc/flash_attention.cu`).

Queries on the CPU take the plain version (`ref.py`, with the kv heads
repeated for GQA); queries on the card launch the kernel or raise — it
never falls back. The kernel reads kv head h // rep for query head h,
so the wrapper passes k and v unrepeated, and it masks the ragged edges
itself, so nothing is padded. The kernel has no backward, as the
reference's Pallas kernel has none: on the card an input that requires
grad raises, where the output would otherwise carry no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.device import KERNEL_LAUNCHES
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

#: Largest head dim the kernel's per-lane accumulators hold.
MAX_D = 128


def _check(q, k, v, causal: bool, window: int | None) -> int:
    """Shapes (B, Hq, Lq, D), (B, Hkv, Lk, D) x 2 with Hq % Hkv == 0, and
    Lk >= Lq wherever a mask reads the query positions (causal or a
    window: end-aligned queries would sit before the first key); returns
    rep = Hq // Hkv."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} are not (B, Hq, Lq, D), (B, Hkv, Lk, D) "
            "with Hq a multiple of Hkv")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if k.shape[2] < q.shape[2] and (causal or window is not None):
        raise ValueError(
            f"Lk {k.shape[2]} < Lq {q.shape[2]}: a causal or windowed mask "
            "aligns the queries to the end of the keys")
    return q.shape[1] // k.shape[1]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D), Hq % Hkv == 0. Queries
    align to the end of the keys (q_offset = Lk - Lq); with neither a
    causal mask nor a window nothing reads that offset, and Lk < Lq is
    taken (cross-attention of a long decoder sequence). Returns
    (B, Hq, Lq, D) in q's dtype."""
    rep = _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        if rep > 1:
            k = k.repeat_interleave(rep, 1)
            v = v.repeat_interleave(rep, 1)
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must share a device")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("the kernel has no backward: an input requires "
                         "grad (train through impl 'naive' or 'chunked', "
                         "as the reference trains outside its kernels)")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, lq, d = q.shape
    lk = k.shape[2]
    if d % 8 or d > MAX_D:
        raise ValueError(f"head dim {d}: the kernel takes a multiple of 8 "
                         f"up to {MAX_D}")
    q, k, v = build.aligned(q), build.aligned(k), build.aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    build.launch("flash_attention", q, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), b * hq, hq, rep, lq, lk, d,
                 lk - lq, lk, int(causal), window or 0, d ** -0.5,
                 int(q.dtype == torch.bfloat16))
    KERNEL_LAUNCHES["flash_attention"] += 1
    return out
