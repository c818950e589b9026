"""The port's SSD wrapper (plain chunked dual form on the CPU) and its
recurrence oracle against the JAX package's `ssd` (the Pallas kernel in
interpret mode) and `ssd_ref`, on the same numpy inputs from a seed, at
the cases and tolerances of tests/test_kernels.py: atol 2e-4 against the
recurrence, chunk invariance within 1e-4, and y = D x as dt -> 0. Plus
Zamba2's head dim and state (P = N = 64). The kernel itself is held
against the same plain version on the card in
tests/test_torch_kernels_card.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.kernels.ssd.ops import ssd as j_ssd  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref  # noqa: E402

from repro_torch.device import KERNEL_LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.ssd import ops, ref  # noqa: E402


def _inputs(seed, b, l, h, p, n, dt_lo=0.001, dt_hi=0.2, a_lo=0.3,
            a_hi=2.0):
    """x, dt, a, b, c, d as numpy float32, drawn as tests/test_kernels.py
    draws them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(0, 1, (b, l, h, p)).astype(f),
            rng.uniform(dt_lo, dt_hi, (b, l, h)).astype(f),
            -rng.uniform(a_lo, a_hi, h).astype(f),
            rng.normal(0, 1, (b, l, n)).astype(f),
            rng.normal(0, 1, (b, l, n)).astype(f),
            rng.normal(0, 1, h).astype(f))


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("l,chunk", [(64, 16), (96, 32), (100, 32),
                                     (128, 128)])
def test_ssd_matches_reference(l, chunk):
    arrs = _inputs(0, 2, l, 3, 16, 8)
    got = ops.ssd(*_t(arrs), chunk=chunk)
    want = j_ssd(*_j(arrs), chunk=chunk)
    oracle, _ = j_ssd_ref(*_j(arrs))
    assert got.shape == (2, l, 3, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-4)


def test_ssd_zamba2_head_and_state():
    """P = N = 64 as in Zamba2, a ragged length (pads 100 -> 128)."""
    arrs = _inputs(1, 1, 100, 2, 64, 64)
    got = ops.ssd(*_t(arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_ssd(*_j(arrs))),
                               atol=2e-4)


def test_ssd_ref_matches_reference():
    """The recurrence oracle, output and final state."""
    arrs = _inputs(2, 2, 40, 3, 8, 4)
    y, s = ref.ssd_ref(*_t(arrs))
    jy, js = j_ssd_ref(*_j(arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)


def test_ssd_chunk_invariance():
    """The chunked dual form is exact: results must not depend on the
    chunk size."""
    arrs = _inputs(3, 1, 128, 2, 8, 4, dt_lo=0.01, dt_hi=0.1, a_lo=0.5,
                   a_hi=1.0)
    outs = [ops.ssd(*_t(arrs), chunk=c).numpy() for c in (16, 32, 64)]
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-4)
    np.testing.assert_allclose(outs[1], outs[2], atol=1e-4)


def test_ssd_state_decay_property():
    """With dt -> 0 the SSD is the identity-decay system: y ~ D x."""
    x, _, _, bm, cm, _ = _inputs(4, 1, 32, 2, 8, 4)
    dt = np.full((1, 32, 2), 1e-8, np.float32)
    a = np.full(2, -1.0, np.float32)
    d = np.full(2, 2.0, np.float32)
    y = ops.ssd(*_t((x, dt, a, bm, cm, d)), chunk=16).numpy()
    np.testing.assert_allclose(y, 2.0 * x, atol=1e-4)


def test_ssd_strong_decay_matches_float64_recurrence():
    """At Zamba2's decays (A = -linspace(1, 16), dt = softplus of a unit
    normal, so A dt reaches ~-50) and head and state of 64, |y| reaches
    the hundreds; the plain version, with its float64 in-chunk cumsum,
    stays within the 2e-4 bar of the exact recurrence taken in float64."""
    rng = np.random.default_rng(8)
    b, l, h, p, n = 1, 256, 4, 64, 64
    x = rng.normal(0, 1, (b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0, 1, (b, l, h)))).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    bm = rng.normal(0, 1, (b, l, n)).astype(np.float32)
    cm = rng.normal(0, 1, (b, l, n)).astype(np.float32)
    d = np.ones(h, np.float32)
    x64, dt64, bm64, cm64 = (v.astype(np.float64) for v in (x, dt, bm, cm))
    state = np.zeros((b, h, p, n))
    want = np.empty((b, l, h, p))
    for t in range(l):
        state = state * np.exp(a * dt64[:, t])[..., None, None] \
            + dt64[:, t, :, None, None] * x64[:, t, :, :, None] \
            * bm64[:, t, None, None, :]
        want[:, t] = np.einsum("bhpn,bn->bhp", state, cm64[:, t]) \
            + x64[:, t]
    assert np.abs(want).max() > 100
    got = ops.ssd(*_t((x, dt, a, bm, cm, d))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_plain_version_counts_no_launch():
    reset_launches()
    ops.ssd(*_t(_inputs(5, 1, 16, 2, 8, 4)))
    assert KERNEL_LAUNCHES["ssd"] == 0


def test_bad_shapes_raise():
    x, dt, a, bm, cm, d = _t(_inputs(6, 1, 16, 2, 8, 4))
    with pytest.raises(ValueError, match="not"):
        ops.ssd(x, dt[:, :, :1], a, bm, cm, d)



def _strong_decay_inputs():
    """The inputs of test_ssd_strong_decay_matches_float64_recurrence:
    Zamba2's decays, head and state of 64, |y| in the hundreds."""
    rng = np.random.default_rng(8)
    b, l, h, p, n = 1, 256, 4, 64, 64
    x = rng.normal(0, 1, (b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0, 1, (b, l, h)))).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    bm = rng.normal(0, 1, (b, l, n)).astype(np.float32)
    cm = rng.normal(0, 1, (b, l, n)).astype(np.float32)
    return x, dt, a, bm, cm, np.ones(h, np.float32)


def test_ssd_bf16_rounding_design_holds_the_bf16_bar():
    """The bf16 kernel's rounding points (`ref.ssd_bf16_emulated`: exact
    bf16 x, B, C; hi + lo bf16 splits of (C B^T o M o dt), of w o B and of
    the float32 state) at Zamba2's strong decays: within the bf16 bar
    (2e-2 + 2^-7 relative, one bf16 ulp) of the plain chunked form on the
    same bf16 inputs, and of the JAX package's chunked SSD."""
    x, dt, a, bm, cm, d = _strong_decay_inputs()
    tx, tdt, ta, tb, tc, td = _t((x, dt, a, bm, cm, d))
    tx, tb, tc = tx.bfloat16(), tb.bfloat16(), tc.bfloat16()
    got = ref.ssd_bf16_emulated(tx, tdt, ta, tb, tc, td).float()
    want = ref.ssd_chunked(tx, tdt, ta, tb, tc, td).float()
    assert got.shape == want.shape and want.abs().max() > 100
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2 ** -7)
    jy = j_ssd(*_j((tx.float().numpy(), dt, a, tb.float().numpy(),
                    tc.float().numpy(), d)))
    torch.testing.assert_close(got, torch.from_numpy(np.array(jy)),
                               atol=2e-2, rtol=2 ** -7)


def test_ssd_bf16_single_rounding_breaks_the_bf16_bar():
    """Why the kernel splits its float32 operands: rounded once to bf16
    instead, on the same strong-decay inputs, they move some outputs past
    the bf16 bar that the hi + lo design holds."""
    tx, tdt, ta, tb, tc, td = _t(_strong_decay_inputs())
    tx, tb, tc = tx.bfloat16(), tb.bfloat16(), tc.bfloat16()
    want = ref.ssd_chunked(tx, tdt, ta, tb, tc, td).float()
    bar = 2e-2 + 2 ** -7 * want.abs()
    for split, fails in ((True, False), (False, True)):
        got = ref.ssd_bf16_emulated(tx, tdt, ta, tb, tc, td,
                                    split=split).float()
        assert bool(((got - want).abs() > bar).any()) == fails


@pytest.mark.parametrize("l,p,n", [(200, 16, 128), (100, 40, 24)])
def test_ssd_bf16_emulation_ragged_and_padded(l, p, n):
    """The same rounding design at a ragged length and at P and N that
    the bf16 kernel pads (tiles of 64 against the reference's chunk)."""
    arrs = _inputs(9, 2, l, 3, p, n)
    tx, tdt, ta, tb, tc, td = _t(arrs)
    tx, tb, tc = tx.bfloat16(), tb.bfloat16(), tc.bfloat16()
    got = ref.ssd_bf16_emulated(tx, tdt, ta, tb, tc, td).float()
    want = ref.ssd_chunked(tx, tdt, ta, tb, tc, td,
                           chunk=min(128, max(l, 8))).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2 ** -7)


def _strong(seed, b, l, h, p, n):
    """Zamba2's decays (a = -linspace(1, 16), dt the softplus of a unit
    normal), unit-normal x, B, C and D = 1, as numpy float32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(0, 1, (b, l, h, p)).astype(f),
            np.log1p(np.exp(rng.normal(0, 1, (b, l, h)))).astype(f),
            -np.linspace(1.0, 16.0, h).astype(f),
            rng.normal(0, 1, (b, l, n)).astype(f),
            rng.normal(0, 1, (b, l, n)).astype(f), np.ones(h, f))


@pytest.mark.parametrize("b,l,h,p,n", [
    (2, 200, 4, 64, 64),     # L not a multiple of the kernel's chunk of 64
    (2, 40, 4, 64, 64),      # L shorter than one chunk
    (1, 1100, 4, 64, 64),    # a chain of 18 chunks at Zamba2's decays
    (1, 300, 3, 16, 32),     # H not a multiple of the head group
    (1, 100, 81, 16, 16),
    (1, 200, 2, 128, 256),   # two P slices, N in four atoms
    (1, 150, 3, 96, 136)])   # a partial P slice, N padded to four atoms
def test_ssd_bf16_emulation_matches_chunked_and_reference(b, l, h, p, n):
    """The kernel's rounding design (`ref.ssd_bf16_emulated`: chunks of
    64, each chunk's state summed from zero and handed over as
    exp(total) S + S_loc, hi + lo splits) at Zamba2's strong decays holds
    the bf16 bar (2e-2 + 2^-7 relative) against the plain chunked form
    and the JAX package's SSD (Pallas, interpret mode) on the same bf16
    inputs."""
    x, dt, a, bm, cm, d = _strong(10 + l + h, b, l, h, p, n)
    tx, tdt, ta, tb, tc, td = _t((x, dt, a, bm, cm, d))
    tx, tb, tc = tx.bfloat16(), tb.bfloat16(), tc.bfloat16()
    got = ref.ssd_bf16_emulated(tx, tdt, ta, tb, tc, td).float()
    want = ref.ssd_chunked(tx, tdt, ta, tb, tc, td,
                           chunk=min(128, max(l, 8))).float()
    assert got.shape == (b, l, h, p)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2 ** -7)
    jy = j_ssd(*_j((tx.float().numpy(), dt, a, tb.float().numpy(),
                    tc.float().numpy(), d)))
    torch.testing.assert_close(got, torch.from_numpy(np.array(jy)),
                               atol=2e-2, rtol=2 ** -7)


def test_ssd_bf16_emulation_chunk_invariant():
    """The hand-over is exact: the emulation at chunks of 32, 64 and 128
    agrees within the bf16 bar (only rounding moves)."""
    tx, tdt, ta, tb, tc, td = _t(_strong(11, 1, 512, 2, 32, 32))
    tx, tb, tc = tx.bfloat16(), tb.bfloat16(), tc.bfloat16()
    outs = [ref.ssd_bf16_emulated(tx, tdt, ta, tb, tc, td, chunk=q).float()
            for q in (32, 64, 128)]
    torch.testing.assert_close(outs[0], outs[1], atol=2e-2, rtol=2 ** -7)
    torch.testing.assert_close(outs[2], outs[1], atol=2e-2, rtol=2 ** -7)


def _model_views(b, l, h, p, n):
    """x, B and C as the model passes them: views of one conv output of
    rows h p + 2n (bf16)."""
    buf = torch.randn((b, l, h * p + 2 * n)).bfloat16()
    xs, bs, cs = torch.split(buf, [h * p, n, n], dim=-1)
    return buf, xs.reshape(b, l, h, p), bs, cs


def test_kernel_operands_read_the_model_views_in_place():
    """The bf16 kernel's operands on Zamba2's path (x, B, C sliced from
    one (B, L, H P + 2N) buffer) go to the kernel as they lie, with their
    row strides; only what TMA cannot read is copied (a head dim or state
    that is not a multiple of 8, a stride that is not 16 bytes)."""
    buf, xh, bs, cs = _model_views(2, 16, 80, 64, 64)
    row = 80 * 64 + 128
    for t, width, want in ((xh, 64, (16 * row, row, 64)),
                           (bs, 64, (16 * row, row)),
                           (cs, 64, (16 * row, row))):
        got, st = ops.kernel_operand(t, width)
        assert got.data_ptr() == t.data_ptr() and st == want
    # batch 1: the batch stride is never stepped and takes L * row
    _, xh1, _, _ = _model_views(1, 16, 80, 64, 64)
    assert ops.kernel_operand(xh1, 64)[1] == (16 * row, row, 64)
    # P 40 pads to 48 (a copy, zeros past P); rows of 8 + 2 * 3 values
    # are not 16 bytes, and N 3 pads to 8: copies
    x40 = torch.randn(2, 16, 3, 40).bfloat16()
    got, st = ops.kernel_operand(x40, 48)
    assert got.shape == (2, 16, 3, 48) and st == (16 * 144, 144, 48)
    assert torch.equal(got[..., :40], x40) and not got[..., 40:].any()
    _, xo, bo, _ = _model_views(2, 16, 1, 8, 3)
    assert ops.tma_strides(xo) is None
    got, st = ops.kernel_operand(xo, 8)
    assert got.is_contiguous() and torch.equal(got, xo) and st == (128, 8, 8)
    got, st = ops.kernel_operand(bo, 8)
    assert torch.equal(got[..., :3], bo) and st == (16 * 8, 8)


def test_ssd_strided_views_equal_contiguous_on_cpu():
    """The wrapper on the model's strided views gives what it gives on
    contiguous copies, bit for bit (the plain version on the CPU)."""
    _, xh, bs, cs = _model_views(2, 70, 4, 16, 8)
    rng = np.random.default_rng(12)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (2, 70, 4))
                          .astype(np.float32))
    a, d = -torch.linspace(1.0, 4.0, 4), torch.ones(4)
    got = ops.ssd(xh, dt, a, bs, cs, d)
    want = ops.ssd(xh.contiguous(), dt, a, bs.contiguous(),
                   cs.contiguous(), d)
    assert torch.equal(got, want)


@pytest.mark.parametrize("p,n", [(96, 128), (128, 256), (160, 320)])
def test_ssd_wide_heads_and_states_match_reference(p, n):
    """Head dims past 64 and states past 128, which the reference's
    kernel takes: P 96 (one slice and a partial one), 128 with N 256 (the
    bf16 kernel's four atoms), 160 with N 320 (past them: the kernel that
    keeps the state in device memory); a ragged L. The port's plain
    version against the Pallas kernel and the recurrence."""
    arrs = _inputs(20 + p + n, 1, 100, 2, p, n)
    got = ops.ssd(*_t(arrs))
    assert got.shape == (1, 100, 2, p) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j_ssd(*_j(arrs))),
                               atol=2e-4)
    oracle, _ = j_ssd_ref(*_j(arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-4)


def test_plan_and_scratch_bytes():
    """The kernel a (P, N) launches and the bf16 kernel's scratch: P in
    slices of 64; bf16 N in 1, 2 or 4 atoms of 64 columns up to 256,
    float32 up to 256 in shared memory, 0 (the state in device memory)
    past 256 in both; 64 bytes of counters, then a slot of na x 2,048
    16-byte units a (batch, head, P slice)."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert ops.plan(64, 64, bf16) == {"na": 1, "p_slices": 1}
    assert ops.plan(16, 128, bf16) == {"na": 2, "p_slices": 1}
    assert ops.plan(96, 136, bf16) == {"na": 4, "p_slices": 2}
    assert ops.plan(160, 256, bf16) == {"na": 4, "p_slices": 3}
    assert ops.plan(128, 264, bf16) == {"na": 0, "p_slices": 2}
    assert ops.plan(40, 20, f32) == {"na": 1, "p_slices": 1}
    assert ops.plan(128, 256, f32) == {"na": 4, "p_slices": 2}
    assert ops.plan(160, 320, f32) == {"na": 0, "p_slices": 3}
    assert ops.scratch_bytes(8, 80, 64, 64) == 64 + 8 * 80 * 2048 * 16
    assert ops.scratch_bytes(2, 4, 64, 128) == 64 + 2 * 4 * 2 * 2048 * 16
    assert ops.scratch_bytes(8, 40, 128, 256) \
        == 64 + 8 * 40 * 2 * 4 * 2048 * 16
