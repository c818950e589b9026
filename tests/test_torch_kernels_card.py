"""The port's four kernels against their plain torch versions on the
card. Every test here needs an NVIDIA card (marker
`cuda`) and skips without one; on the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_card.py

The shapes include the edges of the bf16 tensor-core kernels: ragged
lengths (300, 200), Lk > Lq, windows, GQA rep 2 and 6, head dims that
are not a multiple of 16 (40) or are padded (16), P and N that the
wrapper pads to multiples of 8 (P 40, N 24 and 4); and those of the
Hopper flash kernel's tiling (128 query rows a block in two warpgroups
of 64, 128-key tiles, TMA boxes with zero fill): Lq 300 at GQA rep 6
and D 128, a window of 64 narrower than a key tile at L 512, D 40 and
16 padded to wgmma's depth, Lq 64 over Lk 1,500 non-causal. The bf16
flash kernel needs `sm_90a` (wgmma, TMA, setmaxnreg). So does the bf16
SSD kernel (chunks of 64 steps in parallel, each chunk's state handed to
the next through device memory): its cases add a partial head group (81
heads), L 40 (shorter than a chunk), and the model's operands, x, B and
C sliced from one conv buffer and read in place, which must give the
contiguous call's output bit for bit, as must a repeated call, at
Zamba2's prefill, one 4,096-token prompt, 128 chunks in one chain and N
128.

The forest kernel runs one row, ragged batches, stacks over 48 KB of
tables (T 100 and 256 at D 6), depths 1, 8 and 12 (two tree tiles), K 1,
4 and 10, and batches that take 16 and 8 lanes a row; the template
kernel T 48 to 1,008 with constant, all-zero and tied rows, and its
block path at T 1,056, 1,440, 4,320 and its limit (57,072), at
keep_frac 0.6 and 0.8, with rows in which every deviation ties (the
hot bin of every digit round). Flash also runs causal at Lk < Lq (the
rows before the first key written as the reference's kernel writes
them) and head dims 20 and 100, which the wrapper pads to a multiple of
8. Past the widths of the repo's configurations, flash runs head dims
136, 192, 256 and 320 in both types, with the no-key rows at the
reference's key tiles of 64 and 256, and SSD P 96, 128 and 160 with N
136, 256, 264 and 320, the model's strided operands at P 128 and N 256.

The streamed serving loop (`submit_to`, `depart_to`, `cap_to`, `flush`
with the power-emergency plane) runs on the card at a small width: its
decisions, alarms and throttled-seconds must equal the same stream on the
CPU, the forest kernel must carry every micro-batch, and a second run must
be bit-equal to the first (departures sum in a fixed order). The same holds
with the ballooning rung and the adaptive controller on as well, where the
rung must fire and the controller ratchet and back off.

The training path runs none of the kernels: on the card the flash and
SSD wrappers raise on an input that requires grad, and the MoE dispatch,
the embedding gather and a remat'd block keep their serving numbers bit
for bit, their gradients bit-equal across two runs.

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
    (300, 300, 100, 16, True), (700, 300, None, 64, False),
    (512, 512, 64, 80, True), (300, 300, None, 40, False),
    (300, 700, 100, 16, True), (64, 1500, None, 80, False),
    (300, 700, 128, 20, True), (300, 200, None, 100, True)])
def test_flash_kernel_matches_plain_version(cuda, dtype, lq, lk, window, d,
                                            causal):
    """The last two cases: head dims the wrapper pads to a multiple of 8
    (24, 104), the scale from the true D; the last is causal at Lk < Lq."""
    rng = np.random.default_rng(lq + lk + d)
    q = _normal(rng, 2, 4, lq, d).to(cuda, dtype)
    k = _normal(rng, 2, 2, lk, d).to(cuda, dtype)
    v = _normal(rng, 2, 2, lk, d).to(cuda, dtype)
    reset_launches()
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["flash_attention"] == 1
    want = flash_ref.attention_kernel_ref(q, k.repeat_interleave(2, 1),
                                          v.repeat_interleave(2, 1),
                                          causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,lq,d,causal", [
    (1, 12, 2, 300, 128, True), (2, 48, 8, 300, 128, True),
    (1, 12, 2, 300, 128, False)])
def test_flash_kernel_gqa_rep6_ragged(cuda, dtype, b, hq, hkv, lq, d,
                                      causal):
    """GQA rep 6 (mixtral's, qwen2-vl's) at D 128 with Lq = Lk = 300, not
    a multiple of the bf16 kernel's 128 query rows a block: the last
    block's second warpgroup holds rows past Lq only."""
    rng = np.random.default_rng(hq + lq + d)
    q = _normal(rng, b, hq, lq, d).to(cuda, dtype)
    k = _normal(rng, b, hkv, lq, d).to(cuda, dtype)
    v = _normal(rng, b, hkv, lq, d).to(cuda, dtype)
    rep = hq // hkv
    reset_launches()
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["flash_attention"] == 1
    want = flash_ref.attention_ref(q, k.repeat_interleave(rep, 1),
                                   v.repeat_interleave(rep, 1), causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("lq,lk", [(300, 200), (700, 72)])
def test_flash_kernel_lk_below_lq_causal(cuda, dtype, window, lq, lk):
    """Causal at Lk < Lq, GQA rep 6, D 128: both kernels and the small one
    that writes the first Lq - Lk rows, which see no key, as the
    reference's kernel does (the sum of v over 128 ceil(Lk / 128)); the
    f32 kernel gives such rows partial sums and the bf16 one none, so
    those rows come from the kernel for them alone."""
    rng = np.random.default_rng(lq + lk + (window or 0))
    q = _normal(rng, 1, 12, lq, 128).to(cuda, dtype)
    k = _normal(rng, 1, 2, lk, 128).to(cuda, dtype)
    v = _normal(rng, 1, 2, lk, 128).to(cuda, dtype)
    reset_launches()
    got = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["flash_attention"] == 1
    kr, vr = k.repeat_interleave(6, 1), v.repeat_interleave(6, 1)
    want = flash_ref.attention_kernel_ref(q, kr, vr, causal=True,
                                          window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)
    empty = flash_ref.no_key_value(vr)[:, :, None].to(dtype)
    torch.testing.assert_close(got[:, :, :lq - lk].float(),
                               empty.expand(-1, -1, lq - lk, -1).float(),
                               atol=FLASH_ATOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,h,p,n", [(100, 3, 16, 8), (512, 4, 64, 64),
                                     (200, 2, 64, 128), (5, 2, 8, 4),
                                     (200, 3, 16, 128), (300, 2, 40, 24),
                                     (100, 81, 64, 64), (40, 3, 64, 64),
                                     (100, 3, 96, 128), (200, 2, 128, 256),
                                     (130, 3, 64, 136), (150, 2, 160, 320),
                                     (70, 2, 40, 264)])
def test_ssd_kernel_matches_plain_version(cuda, dtype, l, h, p, n):
    """The last five: P past 64 (slices of 64, the last partial), N in
    four atoms (256, and 136 padded to them), N past 256 (the state in
    device memory)."""
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
@pytest.mark.parametrize("b,l,h,n", [(8, 512, 80, 64), (1, 4096, 80, 64),
                                     (2, 100, 81, 64), (1, 8192, 4, 64),
                                     (2, 300, 3, 128)])
def test_ssd_kernel_strided_views_and_repeats_bit_equal(cuda, b, l, h, n):
    """The bf16 kernel on the model's operands, x, B and C sliced from one
    (B, L, H P + 2N) buffer and read in place, gives the contiguous call's
    output bit for bit, and a repeated call gives it again (each chunk's
    state is summed in a fixed order, whichever block takes it); both
    within the bf16 bar of the plain version. The shapes: Zamba2's
    prefill and one long prompt, a partial head group (81), a long
    hand-over chain (128 chunks), N 128."""
    rng = np.random.default_rng(b + l + h + n)
    p = 64
    buf = _normal(rng, b, l, h * p + 2 * n).to(cuda, torch.bfloat16)
    xs, bs, cs = torch.split(buf, [h * p, n, n], dim=-1)
    xh = xs.reshape(b, l, h, p)
    dt = torch.nn.functional.softplus(_normal(rng, b, l, h)).to(cuda)
    a = -torch.linspace(1.0, 16.0, h, device=cuda)
    d = torch.ones(h, device=cuda)
    reset_launches()
    got = ssd_ops.ssd(xh, dt, a, bs, cs, d)
    again = ssd_ops.ssd(xh, dt, a, bs, cs, d)
    contig = ssd_ops.ssd(xh.contiguous(), dt, a, bs.contiguous(),
                         cs.contiguous(), d)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["ssd"] == 3
    assert torch.equal(got, again) and torch.equal(got, contig)
    want = ssd_ref.ssd_chunked(xh, dt, a, bs, cs, d,
                               chunk=min(128, max(l, 8)))
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,p,n", [(2, 512, 8, 128, 256),
                                       (2, 300, 3, 96, 128),
                                       (1, 200, 2, 160, 320)])
def test_ssd_kernel_wide_strided_views_and_repeats_bit_equal(cuda, b, l, h,
                                                             p, n):
    """P past 64 and N past 128 through the model's operands (x, B and C
    sliced from one (B, L, H P + 2N) buffer, `kernel_operand` reading them
    in place): bit-equal to the contiguous call and to a repeat, within
    the bf16 bar of the plain version. P 128 at N 256 (mamba2's P 64
    doubled, two slices, four atoms), P 96 (a partial slice), N 320 (the
    state in device memory)."""
    rng = np.random.default_rng(b + l + h + p + n)
    buf = _normal(rng, b, l, h * p + 2 * n).to(cuda, torch.bfloat16)
    xs, bs, cs = torch.split(buf, [h * p, n, n], dim=-1)
    xh = xs.reshape(b, l, h, p)
    assert ssd_ops.kernel_operand(xh, p)[0].data_ptr() == xh.data_ptr()
    dt = torch.nn.functional.softplus(_normal(rng, b, l, h)).to(cuda)
    a = -torch.linspace(1.0, 16.0, h, device=cuda)
    d = torch.ones(h, device=cuda)
    reset_launches()
    got = ssd_ops.ssd(xh, dt, a, bs, cs, d)
    again = ssd_ops.ssd(xh, dt, a, bs, cs, d)
    contig = ssd_ops.ssd(xh.contiguous(), dt, a, bs.contiguous(),
                         cs.contiguous(), d)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["ssd"] == 3
    assert torch.equal(got, again) and torch.equal(got, contig)
    want = ssd_ref.ssd_chunked(xh, dt, a, bs, cs, d,
                               chunk=min(128, max(l, 8)))
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [136, 192, 256, 320])
@pytest.mark.parametrize("lq,lk,window,causal", [
    (300, 300, None, True), (300, 700, 128, True), (300, 200, None, True),
    (64, 1500, None, False)])
def test_flash_kernel_wide_head_dims(cuda, dtype, d, lq, lk, window,
                                     causal):
    """Head dims past 128: bf16 136 (padded to the 192 tiling), 192 and
    256 (Q read in place, O staged through Q's tile), float32 up to 256
    (8 slots a lane), 320 in both types (D split over passes and slices);
    GQA rep 2, ragged Lq, a window, causal at Lk < Lq (the no-key rows'
    kernel at D 320 too), non-causal over 1,500 keys; a repeated call
    bit-equal."""
    rng = np.random.default_rng(lq + lk + d)
    q = _normal(rng, 2, 4, lq, d).to(cuda, dtype)
    k = _normal(rng, 2, 2, lk, d).to(cuda, dtype)
    v = _normal(rng, 2, 2, lk, d).to(cuda, dtype)
    reset_launches()
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    again = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["flash_attention"] == 2
    assert torch.equal(got, again)
    want = flash_ref.attention_kernel_ref(q, k.repeat_interleave(2, 1),
                                          v.repeat_interleave(2, 1),
                                          causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 320])
@pytest.mark.parametrize("bk", [64, 256])
def test_flash_kernel_no_key_rows_follow_bk(cuda, dtype, d, bk):
    """The rows that see no key (causal, Lk 40 < Lq 300) at the
    reference's key tiles of 64 and 256: the sum of v over bk
    ceil(Lk / bk), GQA rep 2."""
    rng = np.random.default_rng(d + bk)
    q = _normal(rng, 1, 4, 300, d).to(cuda, dtype)
    k = _normal(rng, 1, 2, 40, d).to(cuda, dtype)
    v = _normal(rng, 1, 2, 40, d).to(cuda, dtype)
    got = flash_ops.flash_attention(q, k, v, causal=True, bk=bk)
    torch.cuda.synchronize()
    want = flash_ref.attention_kernel_ref(q, k.repeat_interleave(2, 1),
                                          v.repeat_interleave(2, 1),
                                          causal=True, bk=bk)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)


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


#: Slots of the block path's tests: its first, 30 and 90 days, the
#: medians' register walk at each of its register tiles (1,056 / 1,440
#: one, 2,880 two, 4,320 three, 6,144 four), the first digit select
#: (6,192) and the shared-memory limit.
LONG_T = [1056, 1440, 2880, 4320, 6144, 6192, template_ops.MAX_T_BLOCK]


@pytest.mark.cuda
@pytest.mark.parametrize("keep_frac", [0.6, 0.8])
@pytest.mark.parametrize("t", LONG_T)
def test_template_long_series_match_plain_version(cuda, t, keep_frac):
    """The block path (T past the register path's 1,024 slots, up to the
    shared-memory limit) at two keep fractions, labels equal."""
    x = torch.from_numpy(_template_rows(np.random.default_rng(t), t)) \
        .to(cuda)
    reset_launches()
    got = template_ops.criticality_scores(x, keep_frac)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["template"] == 1
    want = template_ref.criticality_scores_ref(x, keep_frac)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-4)
    assert torch.equal(got[:, 0] < 0.72, want[:, 0] < 0.72)
    assert float(got[-2:].abs().max()) == 0.0     # constant, zero rows


@pytest.mark.cuda
@pytest.mark.parametrize("keep_frac", [0.6, 0.8])
@pytest.mark.parametrize("t", LONG_T)
def test_template_long_series_all_ties(cuda, t, keep_frac):
    """Rows whose every deviation ties (constant rows: each template is
    the row, each deviation 0), beside one random row: every digit round
    of the selection puts the whole row in one bin."""
    rng = np.random.default_rng(t + 1)
    x = torch.from_numpy(np.concatenate(
        [np.full((1, t), v) for v in (25.0, 0.0, 100.0, 0.5)]
        + [rng.uniform(0, 100, (1, t))]).astype(np.float32)).to(cuda)
    reset_launches()
    got = template_ops.criticality_scores(x, keep_frac)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["template"] == 1
    want = template_ref.criticality_scores_ref(x, keep_frac)
    torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-4)
    assert float(got[:4].abs().max()) == 0.0


@pytest.mark.cuda
def test_template_raises_past_the_shared_memory_limit(cuda):
    t = template_ops.MAX_T_BLOCK + 48
    with pytest.raises(ValueError, match=str(template_ops.MAX_T_BLOCK)):
        template_ops.criticality_scores(torch.ones(2, t, device=cuda))
    assert 0 < template_ops.block_static_smem() \
        <= template_ops.BLOCK_STATIC_SMEM


def _stream_world():
    from repro_torch.core import criticality
    from repro_torch.core import features as F
    from repro_torch.core.predictor import train_service
    from repro_torch.sim.telemetry import generate_population
    pop = generate_population(500, seed=0)
    hist, arrivals = F.split_history_arrivals(pop)
    labels = criticality.classify(hist.series, device="cpu").numpy()
    aggs = F.subscription_aggregates(hist, labels)
    svc = train_service(F.build_features(hist, aggs),
                        labels.astype(np.int64),
                        F.p95_bucket([v.p95_util for v in hist.vms]),
                        n_trees=12)
    return svc, hist, labels, arrivals


def _streamed_run(world, device, hosts):
    """Arrival chunks dealt over `hosts`, departures of the admitted rows
    two chunks back, and a cap sweep of every chassis (one sampled twice)
    every other chunk, stamped between arrival ticks."""
    from repro_torch.serve import (EmergencyConfig, PlaneBundle,
                                   ServeConfig, ServePipeline)
    from repro_torch.sim.telemetry import arrival_batch, arrival_stamps
    svc, hist, labels, arrivals = world
    pipe = ServePipeline.from_history(
        svc, hist, labels, n_servers=48, cores_per_server=40,
        blades_per_chassis=12, device=device, config=ServeConfig(
            batch_size=32, n_ingest_hosts=hosts, planes=PlaneBundle(
                emergency=EmergencyConfig.from_model(1560.0))))
    n = 32 * (len(arrivals.vms) // 32)
    stamps = arrival_stamps(n)
    cores = np.array([v.cores for v in arrivals.vms], np.float32)
    power = np.random.default_rng(3).uniform(1450.0, 1750.0,
                                             (n // 32, 5))
    res = []
    for k in range(n // 32):
        idx = np.arange(32 * k, 32 * (k + 1))
        for h in range(hosts):
            rows = idx[idx % hosts == h]
            res += pipe.submit_to(h, arrival_batch(arrivals, rows),
                                  t=stamps[rows])
        t_end = stamps[idx[-1]]
        if k >= 2:
            r = res[k - 2]
            rows = np.flatnonzero(r.server >= 0)[::2]
            res += pipe.depart_to(
                k % hosts, r.server[rows], cores[32 * (k - 2) + rows],
                r.p95_eff[rows], r.workload_type[rows] == 1,
                t=t_end + 0.25 + 1e-6 * np.arange(len(rows)))
        if k % 2:
            res += pipe.cap_to((k + 1) % hosts, [0, 1, 2, 3, 1], power[k],
                               t=t_end + 0.5 + np.arange(1, 6) * 1e-7)
    tail = pipe.flush()
    res += [] if tail is None else [tail]
    return pipe, res


@pytest.mark.cuda
def test_streamed_serve_with_emergencies_matches_cpu(cuda):
    world = _stream_world()
    reset_launches()
    card, res = _streamed_run(world, cuda, hosts=1)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["forest"] == len(res)
    cpu, res_cpu = _streamed_run(world, "cpu", hosts=1)
    card4, res4 = _streamed_run(world, cuda, hosts=4)
    again, res_again = _streamed_run(world, cuda, hosts=1)
    assert card.alarms > 0
    for other, other_res in ((cpu, res_cpu), (card4, res4),
                             (again, res_again)):
        assert other.alarms == card.alarms
        np.testing.assert_array_equal(other.throttled_by_level(),
                                      card.throttled_by_level())
        for a, b in zip(res, other_res, strict=True):
            np.testing.assert_array_equal(a.server, b.server)
            np.testing.assert_array_equal(a.conservative, b.conservative)
    for f in ("free_cores", "gamma_uf", "gamma_nuf", "res_peak"):
        for other in (again, card4):
            assert torch.equal(getattr(card.state, f),
                               getattr(other.state, f)), f
        torch.testing.assert_close(getattr(card.state, f).cpu(),
                                   getattr(cpu.state, f), rtol=1e-6,
                                   atol=0)


#: Utilization of each sweep of the two-plane stream: calm and rising (the
#: adaptive controller ratchets), hot (it backs off, and the hot chassis'
#: cuts reach past the NUF floor, so the ballooning rung fires), calm.
PLANE_UTILS = [0.40, 0.41, 0.42, 0.43, 0.44, 0.45, 0.95, 0.95,
               0.40, 0.40, 0.40, 0.40, 0.40, 0.40]


def _planes_run(world, device, hosts, samples=None, shards=None):
    """The streamed loop with the emergency plane, its ballooning rung and
    the adaptive controller: arrival chunks dealt over `hosts`, departures
    (with their GB) of the admitted rows two chunks back, and after every
    chunk two sweeps of every chassis. Sweep powers are `samples` when
    given, else `sampled_power` at the next PLANE_UTILS value on the live
    aggregates. With `shards`, a `ShardedServePipeline` under a cluster
    budget. Returns the pipeline, the results, the samples and the most GB
    ballooned out after any sweep."""
    from repro_torch.serve import (AdaptiveConfig, BallooningConfig,
                                   EmergencyConfig, PlaneBundle,
                                   ResourceVector, ServeConfig,
                                   ServePipeline, ShardedServeConfig,
                                   ShardedServePipeline, emergency)
    from repro_torch.sim.telemetry import arrival_batch, arrival_stamps
    svc, hist, labels, arrivals = world
    ecfg = EmergencyConfig.from_model(1560.0)
    planes = dict(emergency=ecfg, ballooning=BallooningConfig(),
                  adaptive=AdaptiveConfig(window=8, min_history=3,
                                          hot_util=0.63, step_up=0.15,
                                          step_down=0.5, ratio_max=3.0))
    cls, cfg, extra = ServePipeline, ServeConfig, {}
    if shards is not None:
        cls, cfg, extra = ShardedServePipeline, ShardedServeConfig, \
            {"n_shards": shards}
        planes["cluster_budget"] = ResourceVector(watts=48 * 112.0 + 1500.0)
    pipe = cls.from_history(
        svc, hist, labels, n_servers=48, cores_per_server=40,
        blades_per_chassis=12, device=device, config=cfg(
            batch_size=32, n_ingest_hosts=hosts,
            planes=PlaneBundle(**planes), **extra))
    n = 16 * len(PLANE_UTILS)
    stamps = arrival_stamps(n)
    cores = np.array([v.cores for v in arrivals.vms], np.float32)
    mem = np.array([v.memory_gb for v in arrivals.vms], np.float32)
    res, swept, ballooned = [], [], []
    for k in range(n // 32):
        idx = np.arange(32 * k, 32 * (k + 1))
        for h in range(hosts):
            rows = idx[idx % hosts == h]
            res += pipe.submit_to(h, arrival_batch(arrivals, rows),
                                  t=stamps[rows])
        t_end = stamps[idx[-1]]
        if k >= 2:
            r = res[k - 2]
            rows = np.flatnonzero(r.server >= 0)[::2]
            res += pipe.depart_to(
                k % hosts, r.server[rows], cores[32 * (k - 2) + rows],
                r.p95_eff[rows], r.workload_type[rows] == 1,
                mem_gb=mem[32 * (k - 2) + rows],
                t=t_end + 0.25 + 1e-6 * np.arange(len(rows)))
        for j in range(2):
            if samples is None:
                st = pipe.state
                rho = emergency.chassis_rho_levels(
                    st.gamma_nuf, st.gamma_uf, st.chassis_servers)
                power = emergency.sampled_power(
                    ecfg, rho, PLANE_UTILS[len(swept)],
                    torch.zeros(rho.shape, dtype=torch.int32, device=device),
                    torch.zeros(4, dtype=torch.bool, device=device)) \
                    .cpu().numpy()
            else:
                power = samples[len(swept)]
            swept.append(power)
            res += pipe.cap_to((k + j + 1) % hosts, np.arange(4), power,
                               t=t_end + 0.5 + 0.1 * j
                               + np.arange(1, 5) * 1e-7)
            ballooned.append(pipe.ballooned_gb())
    tail = pipe.flush()
    res += [] if tail is None else [tail]
    return pipe, res, swept, max(ballooned)


@pytest.mark.cuda
def test_streamed_serve_with_both_planes_matches_cpu(cuda):
    """Ballooning and the adaptive controller on the card: decisions,
    alarms, throttled-seconds and the controller state equal the same
    stream (same sweep powers) on the CPU and at 4 hosts; a second card
    run is bit-equal; the rung fires and the ratio both ratchets and
    backs off."""
    world = _stream_world()
    reset_launches()
    card, res, samples, peak_gb = _planes_run(world, cuda, hosts=1)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["forest"] == len(res)
    runs = [_planes_run(world, "cpu", 1, samples),
            _planes_run(world, cuda, 4, samples),
            _planes_run(world, cuda, 1)]
    st = card.adaptive_state
    assert int(st.ratchets) > 0 and int(st.backoffs) > 0
    assert card.alarms > 0 and peak_gb > 0
    for other, other_res, _, _ in runs:
        assert other.alarms == card.alarms
        np.testing.assert_array_equal(other.throttled_by_level(),
                                      card.throttled_by_level())
        for a, b in zip(res, other_res, strict=True):
            np.testing.assert_array_equal(a.server, b.server)
            np.testing.assert_array_equal(a.conservative, b.conservative)
        for f in ("count", "head", "ratio", "ratchets", "backoffs"):
            assert torch.equal(getattr(st, f).cpu(),
                               getattr(other.adaptive_state, f).cpu()), f
    # the CPU's aggregates may differ from the card's in the last float32
    # bit (as in the emergency-only stream above), and the windows and
    # balloons read them; two card runs are bit-equal
    cpu = runs[0][0]
    torch.testing.assert_close(cpu.adaptive_state.util, st.util.cpu(),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(cpu.balloon_state.ballooned_gb,
                               card.balloon_state.ballooned_gb.cpu(),
                               rtol=1e-6, atol=1e-6)
    assert runs[0][3] == pytest.approx(peak_gb, rel=1e-6)
    again = runs[2]
    assert all(np.array_equal(a, b) for a, b in zip(again[2], samples))
    assert again[3] == peak_gb
    for pipe in (runs[1][0], again[0]):
        for f in ("free_cores", "gamma_uf", "gamma_nuf", "res_peak",
                  "mem_nuf"):
            assert torch.equal(getattr(card.state, f),
                               getattr(pipe.state, f)), f
        assert torch.equal(card.balloon_state.ballooned_gb,
                           pipe.balloon_state.ballooned_gb)
        assert torch.equal(st.util, pipe.adaptive_state.util)


@pytest.mark.cuda
def test_sharded_streamed_planes_match_cpu(cuda):
    """`ShardedServePipeline` at 4 shards under a cluster budget, with the
    three planes, on the card: decisions, alarms, throttled-seconds,
    per-shard ratios and spill counters equal the same stream (same sweep
    powers) on the CPU and at 4 hosts; a second card run is bit-equal,
    pools included; the forest kernel carries every micro-batch and the
    admitted rho never exceeds the budget's pool."""
    from repro_torch.serve import rho_pool_from_budget
    world = _stream_world()
    reset_launches()
    card, res, samples, peak_gb = _planes_run(world, cuda, 1, shards=4)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["forest"] == len(res)
    runs = [_planes_run(world, "cpu", 1, samples, shards=4),
            _planes_run(world, cuda, 4, samples, shards=4),
            _planes_run(world, cuda, 1, shards=4)]
    assert card.alarms > 0 and peak_gb > 0
    assert card.spill_info["spilled"] > 0
    for other, other_res, _, _ in runs:
        assert other.alarms == card.alarms
        assert other.spill_info == card.spill_info
        np.testing.assert_array_equal(other.throttled_by_level(),
                                      card.throttled_by_level())
        np.testing.assert_array_equal(other.adaptive_ratio,
                                      card.adaptive_ratio)
        for a, b in zip(res, other_res, strict=True):
            np.testing.assert_array_equal(a.server, b.server)
    for pipe in (runs[1][0], runs[2][0]):
        assert torch.equal(pipe.sharded.pool, card.sharded.pool)
        for a, b in zip(pipe.global_state(), card.global_state()):
            assert torch.equal(a, b)
    rho = float(card.global_state().rho_peak.double().sum())
    assert rho <= rho_pool_from_budget(48 * 112.0 + 1500.0, 48) + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b",
                                  "whisper-tiny", "qwen2-vl-72b"])
def test_lm_family_kernel_forward_matches_plain(cuda, arch):
    """Reduced moe, audio and vlm models in float32 on the card: the
    forward through the flash kernel (a launch a self-attention layer,
    and a cross-attention layer for whisper) equals the plain forward
    within the float32 LM bar, 1e-4 (tests/test_torch_lm.py), and serves
    the same tokens on the card as on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import transformer as T
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    on_card = _to(params, cuda)
    rng = np.random.default_rng(7)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (2, 40)), device=cuda)}
    if cfg.family == "audio":
        batch["frames"] = _normal(rng, 2, cfg.encoder_frames,
                                  cfg.d_model).to(cuda)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = _normal(rng, 2, 8, cfg.d_model).to(cuda)
    reset_launches()
    got = T.forward(cfg, on_card, batch, impl="cuda")
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["flash_attention"] == cfg.n_layers * (
        2 if cfg.family == "audio" else 1)
    want = T.forward(cfg, on_card, batch, impl="chunked")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    if cfg.family != "audio":       # zero bf16 frames need a bf16 model
        prompts = rng.integers(0, cfg.vocab_size, (2, 6))
        np.testing.assert_array_equal(serve_batch(cfg, on_card, prompts, 4),
                                      serve_batch(cfg, params, prompts, 4))


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.cuda
def test_kernel_wrappers_refuse_inputs_that_require_grad(cuda):
    """The kernels have no backward (nor has the reference's Pallas):
    on the card an input that requires grad raises, where the output
    would otherwise carry no gradient; the same inputs without grad
    launch."""
    rng = np.random.default_rng(0)
    q = _normal(rng, 1, 2, 64, 32).to(cuda)
    k, v = (_normal(rng, 1, 2, 64, 32).to(cuda) for _ in range(2))
    with pytest.raises(ValueError, match="backward"):
        flash_ops.flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(ValueError, match="backward"):
        flash_ops.flash_attention(q.detach(), k, v.requires_grad_())
    x = _normal(rng, 1, 64, 2, 16).to(cuda)
    dt = torch.rand(1, 64, 2, device=cuda) * 0.1
    a, d = -torch.rand(2, device=cuda), torch.ones(2, device=cuda)
    b, c = (_normal(rng, 1, 64, 8).to(cuda) for _ in range(2))
    with pytest.raises(ValueError, match="backward"):
        ssd_ops.ssd(x.requires_grad_(), dt, a, b, c, d)
    reset_launches()
    flash_ops.flash_attention(q.detach(), k, v.detach())
    ssd_ops.ssd(x.detach(), dt, a, b, c, d)
    assert KERNEL_LAUNCHES["flash_attention"] == 1
    assert KERNEL_LAUNCHES["ssd"] == 1


@pytest.mark.cuda
def test_training_forms_keep_serving_numbers_and_repeat(cuda):
    """On the card: the differentiable MoE dispatch and `F.embedding` give
    the serving forms' outputs bit for bit, a remat'd forward is the
    forward, and two backward passes give bit-equal gradients."""
    from _torch_parity import check_training_forms
    check_training_forms(cuda)
