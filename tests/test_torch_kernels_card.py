"""The port's flash-attention and SSD kernels against their plain torch
versions on the card. Every test here needs an NVIDIA card (marker
`cuda`) and skips without one; on the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_card.py

The shapes include the edges of the bf16 tensor-core kernels: ragged
lengths (300, 200), Lk > Lq, windows, GQA rep 2, head dims that are not
a multiple of 16 (40) or are padded (16), P and N that the wrapper pads
to multiples of 8 (P 40, N 24 and 4).

Bars: flash atol 2e-5 in float32 and 2e-2 in bf16, SSD atol 2e-4 in
float32 (tests/test_kernels.py). An SSD output in bf16 can round to the
neighbouring bf16 value, so it gets the bf16 bar plus one bf16 ulp (at
most 2^-7 relative).
"""
import numpy as np
import pytest
import torch

from _torch_parity import cuda  # noqa: F401
from repro_torch.device import KERNEL_LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref

FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _normal(rng, *shape):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,window,d,causal", [
    (100, 200, 50, 32, True), (512, 512, None, 80, True),
    (64, 192, None, 128, True), (64, 96, None, 16, False),
    (256, 256, 64, 80, True), (300, 300, None, 40, True),
    (300, 700, 128, 80, True), (300, 700, None, 128, False),
    (300, 300, 100, 16, True)])
def test_flash_kernel_matches_plain_version(cuda, dtype, lq, lk, window, d,
                                            causal):
    rng = np.random.default_rng(lq + lk + d)
    q = _normal(rng, 2, 4, lq, d).to(cuda, dtype)
    k = _normal(rng, 2, 2, lk, d).to(cuda, dtype)
    v = _normal(rng, 2, 2, lk, d).to(cuda, dtype)
    reset_launches()
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["flash_attention"] == 1
    want = flash_ref.attention_ref(q, k.repeat_interleave(2, 1),
                                   v.repeat_interleave(2, 1), causal=causal,
                                   window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,h,p,n", [(100, 3, 16, 8), (512, 4, 64, 64),
                                     (200, 2, 64, 128), (5, 2, 8, 4),
                                     (200, 3, 16, 128), (300, 2, 40, 24)])
def test_ssd_kernel_matches_plain_version(cuda, dtype, l, h, p, n):
    rng = np.random.default_rng(l + p + n)
    x = _normal(rng, 2, l, h, p).to(cuda, dtype)
    dt = torch.from_numpy(rng.uniform(0.001, 0.2, (2, l, h))
                          .astype(np.float32)).to(cuda)
    a = -torch.from_numpy(rng.uniform(0.3, 2.0, h).astype(np.float32)) \
        .to(cuda)
    bm = _normal(rng, 2, l, n).to(cuda, dtype)
    cm = _normal(rng, 2, l, n).to(cuda, dtype)
    d = _normal(rng, h).to(cuda)
    reset_launches()
    got = ssd_ops.ssd(x, dt, a, bm, cm, d)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["ssd"] == 1
    want = ssd_ref.ssd_chunked(x, dt, a, bm, cm, d,
                               chunk=min(128, max(l, 8)))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-4, rtol=0)
        exact, _ = ssd_ref.ssd_ref(x, dt, a, bm, cm, d)
        torch.testing.assert_close(got, exact, atol=2e-4, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2 ** -7)
