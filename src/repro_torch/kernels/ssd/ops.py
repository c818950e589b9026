"""Wrapper of the Mamba2 SSD kernel (`csrc/ssd.cu`).

Tensors on the CPU take the plain chunked dual form (`ref.ssd_chunked`)
at the chunk min(128, max(L, 8)), with L padded to a multiple of it by
dt = 0 steps (exact no-ops), as `repro.kernels.ssd.ops` does. Tensors on
the card launch the kernel or raise — it never falls back. The kernel
has no backward, as the reference's has none: on the card an input that
requires grad raises.

On the card, float32 operands are made contiguous and L padded as on
the CPU. bf16 operands are read where they lie: x, B and C may be
strided views (the model passes slices of its conv output, rows of
d_inner + 2N), read by TMA over their strides, so the wrapper copies
none of them unless a stride is not a multiple of 16 bytes or P or N is
not a multiple of 8 — a layout copy, after which the kernel still runs.
The bf16 kernel handles a ragged L itself. It hands each chunk's state
to the next through scratch in device memory that the wrapper keeps,
one buffer per (device, stream), zeroed once when allocated; each call
passes a new epoch, which tags the states' units, so a unit that an
earlier call left never reads as ready and no call needs a memset.

Any P and N: every kernel cuts P into slices of 64 (`plan`); the bf16
Hopper kernel holds N up to 256 and the float32 kernel's shared tiles
256; past 256 both types go to a plain CUDA-core kernel that keeps the
carried state in device memory (a (B, H, P, N) buffer the wrapper
allocates each call, float64 for float32 operands, whose sums there are
float64 too).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import KERNEL_LAUNCHES
from repro_torch.kernels import build
from repro_torch.kernels.ssd import ref

CHUNK = 128
#: Columns of P a block or work tile of every kernel takes.
P_SLICE = 64
#: Bytes of the bf16 kernel's scratch ahead of its states (the work
#: counter and the count of blocks done), and of one 16-byte unit.
SCRATCH_COUNTERS, UNIT_BYTES = 64, 16

#: (device index, raw stream) -> [scratch tensor, last epoch]. The
#: scratch outlives a call (zeroed once, so no call launches a memset);
#: a stream runs its calls in order, so one buffer a stream is enough.
_SCRATCH: dict = {}


def plan(p: int, n: int, dtype: torch.dtype) -> dict:
    """How the kernel takes head dim `p` and state `n` (for bf16 the
    wrapper's multiples of 8): `na`, the kernel `ssd_scan` launches —
    bf16 the Hopper kernel with N in na = 1, 2 or 4 atoms of 64 columns,
    float32 the shared-memory kernel (na = ceil(n / 64), N up to 256);
    0 past N 256, either type, the kernel with the state in device
    memory — and `p_slices`, the slices of 64 columns of P."""
    if n <= 256:
        na = next(a for a in (1, 2, 4) if n <= 64 * a) \
            if dtype == torch.bfloat16 else -(-n // 64)
    else:
        na = 0
    return {"na": na, "p_slices": -(-p // P_SLICE)}


def scratch_bytes(batch: int, h: int, p: int, n: int) -> int:
    """Bytes of scratch the bf16 Hopper kernel needs at (p, n): the
    counters, then one state slot a (batch, head, P slice), its S^T
    fragments as na x 2,048 16-byte units (two floats and a tag) for the
    128 threads of a consumer warpgroup."""
    pl = plan(p, n, torch.bfloat16)
    return SCRATCH_COUNTERS + batch * h * pl["p_slices"] * pl["na"] \
        * 2048 * UNIT_BYTES


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


def tma_strides(t) -> tuple | None:
    """The strides (in elements) of every dim of `t` but its last, as
    the bf16 kernel's TMA maps read them, or None when they cannot: the
    last dim must be contiguous, every other stride a multiple of 8
    elements (16 bytes of bf16) and the data 16-byte aligned. A dim of
    size 1 is never stepped: it takes the stride a contiguous tensor
    would give it."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return None
    out, inner = [], t.shape[-1]
    for n, st in reversed(list(zip(t.shape[:-1], t.stride()[:-1]))):
        st = inner if n == 1 else st
        if st % 8:
            return None
        out.append(st)
        inner = st * n
    return tuple(reversed(out))


def kernel_operand(t, width: int):
    """`t` (last dim `width` or less) as the bf16 kernel reads it, with
    its TMA strides: the tensor itself when its last dim is `width` and
    TMA can read it as it lies, else a zero-padded contiguous copy."""
    if t.shape[-1] == width:
        st = tma_strides(t)
        if st is not None:
            return t, st
    t = build.aligned(F.pad(t, (0, width - t.shape[-1])))
    return t, tma_strides(t)


def _scratch(dev: torch.device, nbytes: int):
    """This stream's scratch of at least `nbytes` and a new epoch."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (idx, torch._C._cuda_getCurrentRawStream(idx))
    ent = _SCRATCH.get(key)
    if ent is None or ent[0].numel() < nbytes:
        ent = _SCRATCH[key] = [
            torch.zeros(nbytes, dtype=torch.uint8, device=dev),
            0 if ent is None else ent[1]]
    ent[1] += 1
    return ent[0], ent[1]


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
    if x.numel() == 0:
        return torch.empty_like(x)
    if x.dtype == torch.float32:
        return _ssd_f32(x, dt, a, b, c, d, ch)
    # P and N padded to multiples of 8 (zeros are exact) where they are not
    pp, nn = -(-p // 8) * 8, -(-n // 8) * 8
    x, xs = kernel_operand(x, pp)
    b, bs = kernel_operand(b, nn)
    c, cs = kernel_operand(c, nn)
    dt, a, d = (build.aligned(t) for t in (dt, a, d))
    y = torch.empty((bsz, l, h, pp), dtype=x.dtype, device=x.device)
    na = plan(pp, nn, x.dtype)["na"]
    if na:
        scratch, epoch = _scratch(x.device, scratch_bytes(bsz, h, pp, nn))
    else:
        scratch, epoch = _wide_state(bsz, h, pp, nn, x.dtype, x.device), 0
    build.launch("ssd_scan", x, x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                 b.data_ptr(), c.data_ptr(), d.data_ptr(), y.data_ptr(), bsz,
                 l, h, pp, nn, 1, na, *xs, *bs, *cs, scratch.data_ptr(),
                 epoch)
    KERNEL_LAUNCHES["ssd"] += 1
    return y[..., :p]


def _wide_state(bsz, h, p, n, dtype, dev):
    """The carried state of the kernel past N 256 for operands of `dtype`:
    (B, H, P, N), float64 for float32 and float32 for bf16, written by
    each sequence's first chunk before any read."""
    st = torch.float64 if dtype == torch.float32 else torch.float32
    return torch.empty((bsz, h, p, n), dtype=st, device=dev)


def _ssd_f32(x, dt, a, b, c, d, ch):
    """The float32 kernel: contiguous operands, L padded to the chunk."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    pad = (-l) % ch
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    x, dt, a, b, c, d = (build.aligned(t) for t in (x, dt, a, b, c, d))
    y = torch.empty_like(x)
    lp = l + pad
    na = plan(p, n, x.dtype)["na"]
    state = None if na else _wide_state(bsz, h, p, n, x.dtype, x.device)
    build.launch("ssd_scan", x, x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                 b.data_ptr(), c.data_ptr(), d.data_ptr(), y.data_ptr(), bsz,
                 lp, h, p, n, 0, na, lp * h * p, h * p, p, lp * n, n,
                 lp * n, n, None if state is None else state.data_ptr(), 0)
    KERNEL_LAUNCHES["ssd"] += 1
    return y[:, :l]
