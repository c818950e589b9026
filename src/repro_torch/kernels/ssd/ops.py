"""Wrapper of the Mamba2 SSD kernel (`csrc/ssd.cu`).

As `repro.kernels.ssd.ops`, it pads L to a multiple of the chunk
min(128, max(L, 8)) with dt = 0 steps, which are exact no-ops, and cuts
the result back to L. Tensors on the CPU take the plain chunked dual form
(`ref.ssd_chunked`) at that chunk; tensors on the card launch the kernel
or raise — it never falls back. The kernel has no backward, as the
reference's has none: on the card an input that requires grad raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import KERNEL_LAUNCHES
from repro_torch.kernels import build
from repro_torch.kernels.ssd import ref

CHUNK = 128
#: Largest head dim and state size the kernel's shared tiles hold.
MAX_P, MAX_N = 64, 128


def _check(x, dt, a, b, c, d) -> None:
    bsz, l, h, p = x.shape if x.ndim == 4 else (None,) * 4
    if x.ndim != 4 or dt.shape != (bsz, l, h) or a.shape != (h,) \
            or d.shape != (h,) or b.ndim != 3 or b.shape[:2] != (bsz, l) \
            or c.shape != b.shape:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, d "
            f"{tuple(d.shape)} are not (B, L, H, P), (B, L, H), (H,), "
            "(B, L, N), (B, L, N), (H,)")


def ssd(x, dt, a, b, c, d=None, chunk: int = CHUNK):
    """Mamba2 SSD: x (B, L, H, P), dt (B, L, H), a (H,), b/c (B, L, N),
    d (H,) skip. Returns y (B, L, H, P) in x's dtype."""
    if d is None:
        d = torch.zeros(x.shape[2], dtype=torch.float32, device=x.device)
    _check(x, dt, a, b, c, d)
    l = x.shape[1]
    ch = min(chunk, max(l, 8))
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, a, b, c, d, chunk=ch)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if any(t.device != x.device for t in (dt, a, b, c, d)):
        raise ValueError("SSD operands must share x's device")
    if any(t.requires_grad for t in (x, dt, a, b, c, d)):
        raise ValueError("the kernel has no backward: an input requires "
                         "grad (train through impl 'chunked', as the "
                         "reference trains outside its kernel)")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError("x, b, c must all be float32 or all bfloat16, got "
                         f"{x.dtype}, {b.dtype}, {c.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, a, d)):
        raise ValueError("dt, a and d must be float32")
    bsz, _, h, p = x.shape
    n = b.shape[-1]
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"head dim {p} and state {n}: the kernel takes "
                         f"up to {MAX_P} and {MAX_N}")
    pad = (-l) % ch
    # the bf16 kernel copies rows of 8 values (16 bytes): P and N are
    # padded to multiples of 8 with zeros, which is exact
    bf16 = x.dtype == torch.bfloat16
    pp, nn = (-(-p // 8) * 8, -(-n // 8) * 8) if bf16 else (p, n)
    if pad or pp != p:
        x = F.pad(x, (0, pp - p, 0, 0, 0, pad))
    if pad:
        dt = F.pad(dt, (0, 0, 0, pad))
    if pad or nn != n:
        b = F.pad(b, (0, nn - n, 0, pad))
        c = F.pad(c, (0, nn - n, 0, pad))
    x, dt, a, b, c, d = (build.aligned(t) for t in (x, dt, a, b, c, d))
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y[:, :l, :, :p]
    build.launch("ssd_scan", x, x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                 b.data_ptr(), c.data_ptr(), d.data_ptr(), y.data_ptr(), bsz,
                 l + pad, h, pp, nn, int(bf16))
    KERNEL_LAUNCHES["ssd"] += 1
    return y[:, :l, :, :p]
