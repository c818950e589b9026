"""Plain torch versions of the Mamba2 SSD kernel.

`ssd_chunked` is the chunked dual form the kernel computes (the math of
`repro.kernels.ssd.ssd` and of `repro.models.ssm._ssd_chunked_xla`);
the wrapper takes it for CPU tensors. Like the kernel, it takes the
in-chunk cumsum of A dt in float64: in float32, cum_i - cum_j cancels
at strong decays (Zamba2's A dt reaches -48), enough to move y past the
2e-4 bar once |y| is in the hundreds
(tests/test_torch_ssd.py::test_ssd_strong_decay_matches_float64_recurrence
holds the float64 form to it). `ssd_ref` is the exact per-step
linear recurrence of `repro.kernels.ssd.ref`, float32:

    S_t = S_{t-1} * exp(A_h dt_t) + dt_t * x_t (x) B_t
    y_t = C_t . S_t + D_h x_t
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_chunked(x, dt, a, b, c, d, chunk: int = 128):
    """x: (B, L, H, P); dt: (B, L, H); a, d: (H,); b, c: (B, L, N).
    Pads L to a multiple of `chunk` with dt = 0 steps (exact no-ops) and
    scans the chunks in float32. Returns y (B, L, H, P) in x's dtype."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    pad = (-l) % chunk
    x32, dt32, b32, c32 = x.float(), dt.float(), b.float(), c.float()
    if pad:
        x32 = F.pad(x32, (0, 0, 0, 0, 0, pad))
        dt32 = F.pad(dt32, (0, 0, 0, pad))
        b32 = F.pad(b32, (0, 0, 0, pad))
        c32 = F.pad(c32, (0, 0, 0, pad))
    nc = (l + pad) // chunk
    xc = x32.reshape(bsz, nc, chunk, h, p).permute(1, 0, 3, 2, 4)
    dtc = dt32.reshape(bsz, nc, chunk, h).permute(1, 0, 3, 2)
    bc = b32.reshape(bsz, nc, chunk, n).transpose(0, 1)
    cc = c32.reshape(bsz, nc, chunk, n).transpose(0, 1)
    idx = torch.arange(chunk, device=x.device)
    lower = idx[:, None] >= idx[None, :]
    ninf = torch.full((), float("-inf"), device=x.device)
    a32 = a.float()

    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for xq, dtq, bq, cq in zip(xc, dtc, bc, cc):
        adt = a32[None, :, None] * dtq                   # (B, H, Q) <= 0
        cum = torch.cumsum(adt.double(), -1)
        total = cum[..., -1]
        # mask BEFORE exp: for i < j the exponent is positive
        diff = cum[..., :, None] - cum[..., None, :]
        m = torch.exp(torch.where(lower, diff, ninf).float())
        scores = torch.einsum("bqn,bkn->bqk", cq, bq)
        xdt = xq * dtq[..., None]                        # (B, H, Q, P)
        y = torch.einsum("bhqk,bhkp->bhqp", scores[:, None] * m, xdt)
        y = y + torch.exp(cum.float())[..., None] * torch.einsum(
            "bqn,bhpn->bhqp", cq, state)
        w = torch.exp((total[..., None] - cum).float())[..., None] * xdt
        state = torch.exp(total.float())[..., None, None] * state \
            + torch.einsum("bhqp,bqn->bhpn", w, bq)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(bsz, l + pad, h, p)
    y = y + d.float()[None, None, :, None] * x32
    return y[:, :l].to(x.dtype)


def ssd_ref(x, dt, a, b, c, d=None):
    """x: (B, L, H, P); dt: (B, L, H); a: (H,) (negative); b, c:
    (B, L, N) shared across heads; d: (H,) skip. Returns y (B, L, H, P)
    in x's dtype and the final state (B, H, P, N)."""
    x32, dt32, b32, c32 = x.float(), dt.float(), b.float(), c.float()
    bsz, l, h, p = x.shape
    state = torch.zeros((bsz, h, p, b.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(l):
        decay = torch.exp(a.float()[None, :] * dt32[:, t])          # (B, H)
        inject = dt32[:, t, :, None, None] * x32[:, t, :, :, None] \
            * b32[:, t, None, None, :]                              # (B,H,P,N)
        state = state * decay[..., None, None] + inject
        ys.append(torch.einsum("bhpn,bn->bhp", state, c32[:, t]))
    y = torch.stack(ys, 1)
    if d is not None:
        y = y + d.float()[None, None, :, None] * x32
    return y.to(x.dtype), state


def _split_bf16(v, split: bool = True):
    """v as hi + lo, both rounded to bf16 (returned in float32): the
    float32 operand of a tensor-core product taken in two passes; with
    `split` False, v rounded once and a zero lo."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float() if split else torch.zeros_like(v)


def ssd_bf16_emulated(x, dt, a, b, c, d, chunk: int = 64,
                      split: bool = True):
    """The bf16 kernel's rounding points, in torch, for the CPU tests (the
    port never calls it): x, B, C exact bf16; per chunk of `chunk` steps
    (the kernel's 64), C B^T in float32 (once for every head: the numbers
    do not depend on how heads are grouped); (C B^T o M o dt_j) and
    (w o B), w = exp(total - cum) dt, each split into hi + lo bf16 before
    its product (rounded once instead when `split` is False, the design
    the kernel rejects); the chunk's own state x^T (w o B) summed from
    zero, then added to the decayed carried state at the hand-over,
    S_c = exp(total) S_{c-1} + S_loc, in float32; the carried state split
    into hi + lo for C S^T; float32 sums; y rounded to bf16. Shapes as
    `ssd_chunked`; x, b, c should already be bf16."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    pad = (-l) % chunk
    x32, dt32, b32, c32 = (F.pad(t.float(), (0, 0) * (t.ndim - 2)
                                 + (0, pad)) for t in (x, dt, b, c))
    nt = (l + pad) // chunk
    xc = x32.reshape(bsz, nt, chunk, h, p).permute(1, 0, 3, 2, 4)
    dtc = dt32.reshape(bsz, nt, chunk, h).permute(1, 0, 3, 2)
    bc = b32.reshape(bsz, nt, chunk, n).transpose(0, 1)
    cc = c32.reshape(bsz, nt, chunk, n).transpose(0, 1)
    idx = torch.arange(chunk, device=x.device)
    lower = idx[:, None] >= idx[None, :]
    ninf = torch.full((), float("-inf"), device=x.device)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for xq, dtq, bq, cq in zip(xc, dtc, bc, cc):
        cum = torch.cumsum((a.float()[None, :, None] * dtq).double(), -1)
        total = cum[..., -1:]
        diff = cum[..., :, None] - cum[..., None, :]
        m = torch.exp(torch.where(lower, diff, ninf).float())
        g = torch.einsum("bqn,bkn->bqk", cq, bq)[:, None] * m \
            * dtq[..., None, :]                          # (B, H, Q, Q)
        g_hi, g_lo = _split_bf16(g, split)
        s_hi, s_lo = _split_bf16(state, split)
        y = torch.exp(cum.float())[..., None] * (
            torch.einsum("bqn,bhpn->bhqp", cq, s_hi)
            + torch.einsum("bqn,bhpn->bhqp", cq, s_lo)) \
            + torch.einsum("bhqk,bhkp->bhqp", g_hi, xq) \
            + torch.einsum("bhqk,bhkp->bhqp", g_lo, xq)
        w = torch.exp((total - cum).float()) * dtq       # (B, H, Q)
        wb_hi, wb_lo = _split_bf16(w[..., None] * bq[:, None], split)
        local = torch.einsum("bhqp,bhqn->bhpn", xq, wb_hi) \
            + torch.einsum("bhqp,bhqn->bhpn", xq, wb_lo)
        state = torch.exp(total.float())[..., None] * state + local
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(bsz, l + pad, h, p)
    y = y[:, :l] + d.float()[None, None, :, None] * x.float()
    return y.to(torch.bfloat16)
