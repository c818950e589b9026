"""Wrapper of the flash-attention kernel (`csrc/flash_attention.cu`).

Queries on the CPU take the plain version (`ref.attention_kernel_ref`,
with the kv heads repeated for GQA); queries on the card launch the
kernel or raise — it never falls back. The kernel reads kv head h // rep
for query head h, so the wrapper passes k and v unrepeated, and it masks
the ragged edges itself, so nothing is padded but a head dim off a
multiple of 8, which the wrapper zero-pads (zeros add nothing to q . k)
and slices back off. Queries align to the end of the keys, as the
reference's do, also when Lk < Lq: under a causal mask the first
Lq - Lk rows then see no key, and get the value the reference's kernel
writes for them (`ref.no_key_value`). The kernel has no backward, as the
reference's Pallas kernel has none: on the card an input that requires
grad raises, where the output would otherwise carry no gradient.

Any head dim: the bf16 kernel's Hopper tilings reach 256 and the float32
kernel's accumulators 256 (`tiling` picks one); past 256 both types go
to a plain CUDA-core kernel that splits D (`flash_kernel_wide`). The
reference's tile keywords `bq` and `bk` are taken: `bq` changes no value,
`bk` the no-key rows' value.
"""
from __future__ import annotations

import torch

import torch.nn.functional as F

from repro_torch.device import KERNEL_LAUNCHES
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

#: Head dims (padded) of the bf16 kernel's Hopper tilings, and of the
#: float32 kernel's 4 or 8 accumulator slots of 32 columns a lane.
BF16_TILINGS = (16, 32, 64, 80, 96, 128, 192, 256)
F32_TILINGS = (128, 256)


def tiling(d: int, dtype: torch.dtype) -> int:
    """The kernel a head dim `d` (a multiple of 8) launches: the least
    tiling of its type that holds d (the bf16 kernel reads columns past
    d as TMA's zero fill; the float32 kernel masks them), or 0 past the
    last, the CUDA-core kernel that takes any D in slices."""
    tilings = BF16_TILINGS if dtype == torch.bfloat16 else F32_TILINGS
    return next((t for t in tilings if d <= t), 0)


def _check(q, k, v, window: int | None, bq: int, bk: int) -> int:
    """Shapes (B, Hq, Lq, D), (B, Hkv, Lk, D) x 2 with Hq % Hkv == 0;
    returns rep = Hq // Hkv."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} are not (B, Hq, Lq, D), (B, Hkv, Lk, D) "
            "with Hq a multiple of Hkv")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if bq < 1 or bk < 1:
        raise ValueError(f"bq and bk must be >= 1, got {bq}, {bk}")
    return q.shape[1] // k.shape[1]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    bq: int = 128, bk: int = ref.REF_BK) -> torch.Tensor:
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D), Hq % Hkv == 0. Queries
    align to the end of the keys (q_offset = Lk - Lq, negative when
    Lk < Lq, as in the reference); a query that sees no key (causal, row
    i < Lq - Lk) gets the sum of its kv head's v over bk ceil(Lk / bk),
    as the reference's kernel at key tiles of `bk` gives it; `bq`, the
    reference's query tile, changes no value. Any D. Returns
    (B, Hq, Lq, D) in q's dtype."""
    rep = _check(q, k, v, window, bq, bk)
    if q.device.type == "cpu":
        if rep > 1:
            k = k.repeat_interleave(rep, 1)
            v = v.repeat_interleave(rep, 1)
        return ref.attention_kernel_ref(q, k, v, causal=causal,
                                        window=window, bk=bk)
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
    dp = -(-d // 8) * 8           # the kernel's rows are 16-byte units
    if dp != d:
        q, k, v = (F.pad(t, (0, dp - d)) for t in (q, k, v))
    q, k, v = build.aligned(q), build.aligned(k), build.aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :d]
    build.launch("flash_attention", q, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), b * hq, hq, rep, lq, lk, dp,
                 lk - lq, lk, int(causal), window or 0, d ** -0.5,
                 int(q.dtype == torch.bfloat16), tiling(dp, q.dtype), bk)
    KERNEL_LAUNCHES["flash_attention"] += 1
    return out if dp == d else out[..., :d].contiguous()
