"""The port's four kernels against their plain torch versions on the
card. Every test here needs an NVIDIA card (marker
`cuda`) and skips without one; on the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_card.py

The shapes include the edges of the bf16 tensor-core kernels: ragged
lengths (300, 200), Lk > Lq, windows, GQA rep 2, head dims that are not
a multiple of 16 (40) or are padded (16), P and N that the wrapper pads
to multiples of 8 (P 40, N 24 and 4).

The forest kernel runs one row, ragged batches, stacks over 48 KB of
tables (T 100 and 256 at D 6), depths 1, 8 and 12 (two tree tiles), K 1,
4 and 10, and batches that take 16 and 8 lanes a row; the template kernel T 48 to 1,008 with constant, all-zero and
tied rows.

Bars: forest leaf indices exact, sums within 1e-5 per tree of the plain
version and bit-equal to its emulated summation order; template scores
within rtol 5e-3 / atol 5e-4; flash atol 2e-5 in float32 and 2e-2 in
bf16, SSD atol 2e-4 in float32 (tests/test_kernels.py). An SSD output in bf16 can round to the
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
from repro_torch.kernels.forest import ops as forest_ops
from repro_torch.kernels.forest import ref as forest_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.template import ops as template_ops
from repro_torch.kernels.template import ref as template_ref

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


@pytest.mark.cuda
@pytest.mark.parametrize("b,nf,t,d,k", [
    (1, 4, 48, 6, 2), (256, 4, 48, 6, 2), (300, 4, 48, 6, 2),
    (256, 4, 100, 6, 2), (256, 4, 256, 6, 2), (256, 4, 48, 1, 2),
    (256, 4, 48, 8, 2), (256, 4, 48, 6, 1), (256, 4, 48, 6, 4),
    (256, 4, 48, 6, 10), (130, 1, 400, 12, 3), (65, 2, 33, 3, 2),
    (600, 4, 48, 6, 2), (4096, 4, 48, 6, 2), (4096, 4, 100, 6, 2)])
def test_forest_kernel_matches_plain_version(cuda, b, nf, t, d, k):
    rng = np.random.default_rng(b + t + d + k)
    x = _normal(rng, b, 18).to(cuda)
    fi = torch.from_numpy(rng.integers(0, 18, (nf, t, d))
                          .astype(np.int32)).to(cuda)
    thr = _normal(rng, nf, t, d).to(cuda)
    leaf = _normal(rng, nf, t, 1 << d, k).to(cuda)
    reset_launches()
    got = forest_ops.forest_sums(x, fi, thr, leaf)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["forest"] == 1
    plan = forest_ops.launch_plan(b, 18, nf, t, d, k)
    torch.testing.assert_close(
        got, forest_ref.forest_sums_ref(x, fi, thr, leaf), atol=1e-5 * t,
        rtol=0)
    assert torch.equal(got, forest_ref.forest_sums_lanes(
        x, fi, thr, leaf, tile=plan["tile"], lanes=plan["lanes"]))
    # leaf indices: one-tree forests whose leaf l holds l
    probe = torch.arange(1 << d, dtype=torch.float32, device=cuda) \
        .expand(nf * t, 1, 1 << d)[..., None].contiguous()
    idx = forest_ops.forest_sums(x, fi.reshape(nf * t, 1, d).contiguous(),
                                 thr.reshape(nf * t, 1, d).contiguous(),
                                 probe)[..., 0].round().long()
    assert torch.equal(idx.reshape(b, nf, t),
                       forest_ref.leaf_index_ref(x, fi, thr))


def _template_rows(rng, t):
    rows = rng.uniform(0, 100, (64, t))
    tied = rng.choice([0.0, 50.0, 100.0], (4, t))
    return np.concatenate([rows, tied, np.full((1, t), 25.0),
                           np.zeros((1, t))]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [48, 96, 144, 240, 480, 528, 1008])
def test_template_kernel_matches_plain_version(cuda, t):
    x = torch.from_numpy(_template_rows(np.random.default_rng(t), t)) \
        .to(cuda)
    reset_launches()
    got = template_ops.criticality_scores(x)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["template"] == 1
    want = template_ref.criticality_scores_ref(x)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-4)
    assert float(got[-2:].abs().max()) == 0.0     # constant, zero rows
