"""The port's flash-attention wrapper (plain version on the CPU) against
the JAX package's `flash_attention` (the Pallas kernel in interpret mode)
and `attention_ref`, on the same numpy inputs from a seed, at the cases
and tolerances of tests/test_kernels.py (atol 2e-5 in float32, 2e-2 in
bf16), plus Zamba2's head dim 80. The kernel itself is held against the
same plain version on the card in tests/test_torch_kernels_card.py and
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.kernels.flash_attention.ops import \
    flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as j_ref  # noqa: E402

from repro_torch.device import KERNEL_LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

#: working dtype -> (JAX dtype, torch dtype, atol of tests/test_kernels.py)
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, b, hq, hkv, lq, lk, d, dtype):
    """The same values for both packages: numpy draws rounded once to
    the working dtype through JAX, handed to torch through float32."""
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    arrs = [jnp.asarray(rng.normal(0, 1, s).astype(np.float32)).astype(jdt)
            for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d))]
    ts = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in arrs]
    return arrs, ts


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("lq,lk,window", [
    (128, 128, None), (256, 256, 64), (64, 192, None), (100, 200, 50)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_matches_reference(lq, lk, window, dtype):
    """GQA rep 2, windows 64 and 50, Lq < Lk, ragged 100/200."""
    (q, k, v), (tq, tk, tv) = _inputs(0, 2, 4, 2, lq, lk, 32, dtype)
    tol = DTYPES[dtype][2]
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = j_flash(q, k, v, causal=True, window=window, bq=64, bk=64)
    oracle = j_ref(q.astype(jnp.float32), jnp.repeat(k, 2, 1).astype(
        jnp.float32), jnp.repeat(v, 2, 1).astype(jnp.float32),
        causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol)


def test_flash_non_causal():
    (q, k, v), (tq, tk, tv) = _inputs(1, 1, 2, 2, 64, 96, 16, "f32")
    got = ops.flash_attention(tq, tk, tv, causal=False)
    want = j_flash(q, k, v, causal=False, bq=32, bk=32)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    np.testing.assert_allclose(_np(got), _np(j_ref(q, k, v, causal=False)),
                               atol=2e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_head_dim_80(dtype):
    """Zamba2's head dim, which the kernel takes unpadded."""
    (q, k, v), (tq, tk, tv) = _inputs(2, 1, 4, 4, 96, 96, 80, dtype)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    want = j_flash(q, k, v, causal=True, bq=32, bk=32)
    np.testing.assert_allclose(_np(got), _np(want), atol=DTYPES[dtype][2])


@pytest.mark.parametrize("window", [None, 7])
def test_attention_ref_matches_reference(window):
    (q, k, v), (tq, tk, tv) = _inputs(3, 2, 2, 2, 40, 72, 16, "f32")
    np.testing.assert_allclose(
        _np(ref.attention_ref(tq, tk, tv, causal=True, window=window)),
        _np(j_ref(q, k, v, causal=True, window=window)), atol=1e-6)


def test_plain_version_counts_no_launch():
    _, (tq, tk, tv) = _inputs(4, 1, 2, 1, 8, 8, 16, "f32")
    reset_launches()
    ops.flash_attention(tq, tk, tv)
    assert KERNEL_LAUNCHES["flash_attention"] == 0


def test_bad_shapes_raise():
    q = torch.zeros(1, 3, 8, 16)
    kv = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=0)



def test_flash_takes_lk_below_lq_without_a_mask():
    """Non-causal with no window, nothing reads the queries' end
    alignment, and the wrapper takes Lk < Lq as the reference does (a
    long teacher-forced decoder attending whisper's encoder): at the
    card's edge case (2, 6, 6, 700, 300, 64) against the float32 oracle,
    at a smaller one against the Pallas kernel. A causal mask or a window
    at Lk < Lq is taken too and matches the Pallas kernel at its default
    tiles, the first Lq - Lk rows (no key under the causal mask)
    included."""
    (q, k, v), (tq, tk, tv) = _inputs(6, 2, 6, 6, 700, 300, 64, "f32")
    got = ops.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(got), _np(j_ref(q, k, v, causal=False)),
                               atol=2e-5)
    (q, k, v), (tq, tk, tv) = _inputs(7, 1, 2, 2, 70, 30, 64, "f32")
    np.testing.assert_allclose(
        _np(ops.flash_attention(tq, tk, tv, causal=False)),
        _np(j_flash(q, k, v, causal=False, bq=32, bk=32)), atol=2e-5)
    for causal, window in ((True, None), (False, 16)):
        np.testing.assert_allclose(
            _np(ops.flash_attention(tq, tk, tv, causal=causal,
                                    window=window)),
            _np(j_flash(q, k, v, causal=causal, window=window)), atol=2e-5)


@pytest.mark.parametrize("lq,lk", [(200, 72), (300, 200)])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_lk_below_lq_causal_matches_reference(lq, lk, window, dtype):
    """Causal, with and without a window, at Lk < Lq, GQA rep 2: the port
    against the reference's `flash_attention` in interpret mode at its
    default tiles, the rows that see no key included: those are the sum
    of v over 128 ceil(Lk / 128) (72 keys over 128, 200 over 256), not
    the mean the reference's oracle gives them."""
    (q, k, v), (tq, tk, tv) = _inputs(8, 1, 4, 2, lq, lk, 16, dtype)
    tol = DTYPES[dtype][2]
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = j_flash(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)
    n = lq - lk
    assert ref.no_key_rows(lq, lk, True) == n
    empty = tv.float().sum(2) / (128 * -(-lk // 128))
    np.testing.assert_allclose(
        _np(got[:, :, :n]),
        _np(empty.repeat_interleave(2, 1)[:, :, None].expand(-1, -1, n, -1)),
        atol=tol)
    oracle = j_ref(q.astype(jnp.float32), jnp.repeat(k, 2, 1).astype(
        jnp.float32), jnp.repeat(v, 2, 1).astype(jnp.float32),
        causal=True, window=window)
    np.testing.assert_allclose(_np(got)[:, :, n:], _np(oracle)[:, :, n:],
                               atol=tol)


@pytest.mark.parametrize("d", [20, 100])
def test_flash_head_dim_off_a_multiple_of_8(d):
    """Head dims the kernel's wrapper pads to a multiple of 8: the port's
    plain version against the Pallas kernel at the same D (the reference
    takes any D)."""
    (q, k, v), (tq, tk, tv) = _inputs(9, 1, 4, 2, 96, 160, d, "f32")
    np.testing.assert_allclose(
        _np(ops.flash_attention(tq, tk, tv, causal=True, window=64)),
        _np(j_flash(q, k, v, causal=True, window=64)), atol=2e-5)


def test_no_key_rows_only_under_a_causal_mask():
    assert ref.no_key_rows(200, 72, True) == 128
    assert ref.no_key_rows(200, 72, False) == 0
    assert ref.no_key_rows(72, 200, True) == 0
    assert ref.no_key_rows(5, 0, True) == 0


@pytest.mark.parametrize("causal,window", [(True, None), (True, 100),
                                           (False, None)])
def test_flash_bf16_rounding_design(causal, window):
    """The bf16 kernel's one added rounding (`ref.attention_p_bf16`: the
    probabilities rounded to bf16 before P V) at Zamba2's head dim 80 and
    L 512, GQA rep 2: within the bf16 bar 2e-2 of the float32 oracle, the
    port's and the JAX package's, on the same bf16 inputs."""
    (q, k, v), (tq, tk, tv) = _inputs(5, 1, 4, 2, 512, 512, 80, "bf16")
    tk2, tv2 = tk.repeat_interleave(2, 1), tv.repeat_interleave(2, 1)
    got = ref.attention_p_bf16(tq, tk2, tv2, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    want = ref.attention_ref(tq, tk2, tv2, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)
    oracle = j_ref(q.astype(jnp.float32), jnp.repeat(k, 2, 1).astype(
        jnp.float32), jnp.repeat(v, 2, 1).astype(jnp.float32),
        causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=2e-2)


@pytest.mark.parametrize("d", [136, 192, 256, 320])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_wide_head_dims_match_reference(d, dtype):
    """Head dims past 128, which the reference's kernel takes: 136 (the
    bf16 kernel pads it to its 192 tiling), 192 and 256 (the Hopper
    tilings that read Q in place), 320 (past them: the kernel that splits
    D); GQA rep 2, causal with a window, a ragged Lk > Lq. The port's
    plain version against the Pallas kernel and the float32 oracle."""
    (q, k, v), (tq, tk, tv) = _inputs(10 + d, 1, 4, 2, 80, 112, d, dtype)
    tol = DTYPES[dtype][2]
    got = ops.flash_attention(tq, tk, tv, causal=True, window=48)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = j_flash(q, k, v, causal=True, window=48, bq=32, bk=32)
    oracle = j_ref(q.astype(jnp.float32), jnp.repeat(k, 2, 1).astype(
        jnp.float32), jnp.repeat(v, 2, 1).astype(jnp.float32),
        causal=True, window=48)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol)


@pytest.mark.parametrize("d", [192, 320])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_wide_head_dims_lk_below_lq(d, dtype):
    """Causal at Lk 72 < Lq 150, GQA rep 2, at a Hopper tiling past 128
    and past them: the rows that see no key as the reference's kernel
    writes them at its default tiles."""
    (q, k, v), (tq, tk, tv) = _inputs(20 + d, 1, 4, 2, 150, 72, d, dtype)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_np(got), _np(j_flash(q, k, v, causal=True)),
                               atol=DTYPES[dtype][2])


@pytest.mark.parametrize("lk", [40, 72])
@pytest.mark.parametrize("bk", [64, 128, 256])
def test_flash_no_key_rows_follow_bk(bk, lk):
    """The reference's key tile `bk` sets what a row that sees no key
    gets, the sum of v over bk ceil(Lk / bk) (at Lk 72 the same at bk 64
    and 128, half of it at 256); `bq` changes no value. The port against
    the reference in interpret mode at each bk, causal, Lq = Lk + 56, GQA
    rep 2."""
    (q, k, v), (tq, tk, tv) = _inputs(30 + lk, 1, 4, 2, lk + 56, lk, 16,
                                      "f32")
    got = ops.flash_attention(tq, tk, tv, causal=True, bk=bk)
    np.testing.assert_allclose(
        _np(got), _np(j_flash(q, k, v, causal=True, bk=bk)), atol=2e-5)
    np.testing.assert_allclose(
        _np(got), _np(j_flash(q, k, v, causal=True, bq=32, bk=bk)),
        atol=2e-5)
    empty = tv.float().sum(2) / (bk * -(-lk // bk))
    np.testing.assert_allclose(
        _np(got[:, :, :56]),
        _np(empty.repeat_interleave(2, 1)[:, :, None].expand(-1, -1, 56, -1)),
        atol=2e-5)
    assert torch.equal(
        ops.flash_attention(tq, tk, tv, causal=True, bq=32, bk=bk), got)
    torch.testing.assert_close(ref.no_key_value(tv, bk), empty)


def test_tiling_picks_the_least_that_holds_d():
    """The kernel a padded head dim launches: the bf16 Hopper tilings up
    to 256, the float32 kernel's 4 or 8 slots a lane up to 256, and 0
    (the kernel that splits D) past them."""
    bf16, f32 = torch.bfloat16, torch.float32
    ds = (8, 16, 24, 40, 64, 72, 80, 88, 96, 104, 128, 136, 192, 200, 256,
          264, 320)
    assert [ops.tiling(d, bf16) for d in ds] == [
        16, 16, 32, 64, 64, 80, 80, 96, 96, 128, 128, 192, 192, 256, 256,
        0, 0]
    assert [ops.tiling(d, f32) for d in (8, 128, 136, 256, 264, 320)] == [
        128, 128, 256, 256, 0, 0]


def test_bad_tiles_raise():
    q = torch.zeros(1, 2, 8, 16)
    for kw in ({"bq": 0}, {"bk": 0}):
        with pytest.raises(ValueError, match="bq and bk"):
            ops.flash_attention(q, q, q, **kw)
