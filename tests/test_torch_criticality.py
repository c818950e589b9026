"""Port criticality labeling (`repro_torch.core.criticality`,
`repro_torch.kernels.template`) against the JAX reference, on the CPU.

Tolerances:
- Compare8/Compare12 of the port's `score` within rtol 1e-5 / atol 1e-6
  of `repro.core.criticality.score`: both are sort-based, only the
  summation order differs.
- The per-period deviations within rtol 1e-3: JAX's float32 cumsum is a
  blocked scan whose error, amplified by the cumsum difference of the
  24 h window, moves a low-utilization series' de-trend base by up to
  ~4e-4 relative (the port's `torch.cumsum` is ~4x closer to float64).
  The deviations share that scale, so it cancels in the ratios.
- The port's plain template version against the JAX Pallas kernel in
  interpret mode at that kernel's own bar (rtol 5e-3 / atol 5e-4).
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.core import criticality as RC  # noqa: E402
from repro.kernels.template.ops import criticality_scores as pallas_scores  # noqa: E402,E501
from repro.sim.telemetry import generate_population  # noqa: E402

from repro_torch.core import criticality as PC  # noqa: E402
from repro_torch.core import timeseries as PTS  # noqa: E402
from repro_torch.kernels.template import ops, ref  # noqa: E402

RNG = np.random.default_rng(0)


def _inputs(kind):
    if kind == "population":
        return generate_population(200, seed=9).series
    batch, days = kind
    return RNG.uniform(0, 100, (batch, days * 48)).astype(np.float32)


@pytest.mark.parametrize("kind", ["population", (8, 5), (130, 5), (32, 10)])
def test_score_matches_reference(kind):
    x = _inputs(kind)
    got = PC.score(torch.as_tensor(x))
    want = RC.score(jnp.asarray(x))
    for f in ("compare8", "compare12"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    for f in ("dev24", "dev12", "dev8"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-3, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("period", [48, 24, 16])
def test_template_median_averages_even_counts(period):
    """`jnp.median` averages the two middle values of an even count; the
    port takes the median from a sort to do the same."""
    from repro.core import timeseries as RTS
    x = RNG.normal(0, 1, (4, 480)).astype(np.float32)
    np.testing.assert_allclose(
        PTS.extract_template(torch.as_tensor(x), period).numpy(),
        np.asarray(RTS.extract_template(jnp.asarray(x), period)),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["population", (8, 5), (130, 5), (32, 10)])
def test_plain_template_matches_pallas_interpret(kind):
    x = _inputs(kind)
    got = ref.criticality_scores_ref(torch.as_tensor(x)).numpy()
    want = np.asarray(pallas_scores(jnp.asarray(x), block_b=8))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("days", [5, 10, 30])
def test_classify_labels_equal(days):
    pop = generate_population(200, seed=9)
    x = np.tile(pop.series, (1, days // 5))
    want = np.asarray(RC.classify(jnp.asarray(x)))
    got = PC.classify(x, device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    n_valid = np.where(np.arange(len(x)) % 3 == 0, 100, x.shape[1])
    np.testing.assert_array_equal(
        PC.classify_with_length(x, n_valid, device="cpu").numpy(),
        np.asarray(RC.classify_with_length(jnp.asarray(x),
                                           jnp.asarray(n_valid))))


@pytest.mark.parametrize("keep_frac", [0.5, 0.8, 1.0])
def test_keep_frac_matches_pallas_interpret(keep_frac):
    """The wrapper's `keep_frac` (its plain version on the CPU) against the
    reference's `criticality_scores(series, keep_frac)` in interpret mode
    at 8 x 240, at that kernel's bar."""
    x = RNG.uniform(0, 100, (8, 240)).astype(np.float32)
    got = ops.criticality_scores(torch.as_tensor(x), keep_frac).numpy()
    want = np.asarray(pallas_scores(jnp.asarray(x), keep_frac=keep_frac,
                                    block_b=8))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(
        got, ref.criticality_scores_ref(torch.as_tensor(x), keep_frac),
        rtol=0, atol=0)


@pytest.mark.parametrize("days", [30, 50])
@pytest.mark.parametrize("keep_frac", [0.6, 0.8])
def test_long_series_match_reference_score(days, keep_frac):
    """Series past the kernel's register path (T 1,440 and 2,400): the
    wrapper's plain version against the reference's sort-based
    `core.criticality.score` (its Pallas kernel's sorting network at 90+
    repetitions would take minutes here). Bar rtol 3e-5 / atol 1e-6: the
    float32 sums over 1,440 to 2,400 slots put each package up to ~1e-5
    relative from a float64 run of the same algorithm (measured 7.7e-6
    for the port, 7.3e-6 for the reference at 2,400 slots), on either
    side, where `test_score_matches_reference` holds T <= 480 to
    1e-5."""
    rng = np.random.default_rng(days)
    pop = generate_population(40, seed=3)
    x = np.clip(np.tile(pop.series, (1, days // 5))
                + rng.normal(0, 1, (40, days * 48)), 0, 100) \
        .astype(np.float32)
    got = ops.criticality_scores(torch.as_tensor(x), keep_frac).numpy()
    want = RC.score(jnp.asarray(x), keep_frac)
    np.testing.assert_allclose(got[:, 0], np.asarray(want.compare8),
                               rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(got[:, 1], np.asarray(want.compare12),
                               rtol=3e-5, atol=1e-6)


#: Cases of the long-series path's selects: normal values, ties, both
#: zeros (tiny values beside them), constant rows, and infinities.
DIGIT_CASES = ["normal", "ties", "signed_zeros", "constant", "with_inf"]


def _digit_rows(case, shape, rng):
    """float32 rows of `shape` for a case of DIGIT_CASES: for the medians
    the normalized row (any sign), for the selection (`abs`) the
    deviations, non-negative as |x - template| makes them."""
    if case == "normal":
        x = rng.normal(0, 1, shape)
    elif case == "ties":
        x = rng.choice([-1.0, 0.0, 0.5, 2.0], shape)
    elif case == "signed_zeros":
        x = rng.choice([-0.0, 0.0, -1e-30, 1e-30], shape)
    elif case == "constant":
        x = np.full(shape, -3.25)
    else:
        x = rng.normal(0, 1, shape)
        x[..., ::7] = np.inf
        x[..., 3::11] = -np.inf
    return torch.as_tensor(x.astype(np.float32))


@pytest.mark.parametrize("case", DIGIT_CASES)
@pytest.mark.parametrize("t", [240, 1440, 4320, 6144, 6192,
                               ops.MAX_T_BLOCK])
def test_radix_medians_equal_sorted_medians(case, t):
    """The long-series path's per-slot medians over the 48-column layout's
    1 to 3 runs a slot, both ways the kernel takes them (a register radix
    walk that stops on one key, `ref.slot_medians_walk`, up to 128
    repetitions a column; 5-bit digit selects, `ref.slot_medians_digits`,
    past them; `ref.slot_medians_block` picks as the kernel does), equal
    the sort's bit for bit, for odd and even repetition counts (T / 48 =
    5, 30, 90, 128, 129, 1,189; T / 16 = 15, 90, 270, 384, 387, 3,567),
    on negative values, ties, both zeros, constant slots and infinities;
    6,144 and 6,192 are the last walk and the first digit select."""
    rng = np.random.default_rng(t)
    x = _digit_rows(case, (6 if t <= 6192 else 2, t), rng)
    for p in (48, 24, 16):
        want = PTS.extract_template(x, p).numpy()
        for fn in (ref.slot_medians_walk, ref.slot_medians_digits,
                   ref.slot_medians_block):
            np.testing.assert_array_equal(fn(x, p).numpy(), want,
                                          err_msg=fn.__name__)


@pytest.mark.parametrize("case", DIGIT_CASES)
@pytest.mark.parametrize("t", [1440, 4320, ops.MAX_T_BLOCK])
@pytest.mark.parametrize("keep", ["one", "all", 0.6, 0.8])
def test_digit_selection_picks_the_k_smallest(case, t, keep):
    """The long-series path's selection of the three periods' k-th
    smallest deviations in the same 8-bit digit rounds
    (`ref.smallest_k_digits`) against a sort: v_k and the count under it
    bit for bit, so sum(d < v_k) + (k - below) v_k sums the k values the
    sort-based oracle sums (to float64 rounding: another order); at most
    four rounds, all four on a constant row."""
    k = {"one": 1, "all": t}.get(keep) or ops.keep_count(t, keep)
    rng = np.random.default_rng(t + k)
    dev = _digit_rows(case, (4 if t <= 4320 else 2, 3, t), rng).abs()
    kth, below, rounds, total = ref.smallest_k_digits(dev, k)
    srt = torch.sort(dev, dim=-1).values
    assert torch.equal(kth, srt[..., k - 1])
    assert torch.equal(below, (dev < kth[..., None]).sum(-1))
    assert bool((below < k).all())
    assert bool((rounds <= 4).all())
    if case == "constant":
        assert bool((rounds == 4).all())
    np.testing.assert_allclose(total.numpy(),
                               srt[..., :k].double().sum(-1).numpy(),
                               rtol=1e-12, atol=0)


def test_keep_frac_must_keep_a_slot():
    with pytest.raises(ValueError, match="keep_frac"):
        ops.criticality_scores(torch.ones(2, 48), 0.0)
    with pytest.raises(ValueError, match="keep_frac"):
        ops.criticality_scores(torch.ones(2, 48), 1.2)
    assert ops.MAX_T_BLOCK == 57072 and ops.MAX_T_BLOCK % 48 == 0


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ops.criticality_scores(torch.ones(3, 50))
    with pytest.raises(ValueError):
        ops.criticality_scores(torch.ones(240))


def _selection_rows(case, rng):
    """(rows, n_valid) of non-negative deviations padded with +inf to the
    kernel's width, 256 (T = 240); the kernel's padding never counts."""
    n, width = 240, 256
    if case == "random":
        d = rng.exponential(1.0, (64, n))
    elif case == "ties":
        d = rng.choice([0.0, 0.25, 0.5, 1.0], (64, n))
    elif case == "constant":
        d = np.full((4, n), 0.75)
    elif case == "zeros":
        d = np.zeros((4, n))
    elif case == "with_inf":           # an infinite deviation in the row
        d = rng.exponential(1.0, (16, n))
        d[:, ::7] = np.inf
    else:                              # denormals next to large values
        d = rng.choice([0.0, 1e-40, 3e-39, 1e30, 2.0], (16, n))
    pad = np.full((d.shape[0], width - n), np.inf)
    return np.concatenate([d, pad], 1).astype(np.float32), n


@pytest.mark.parametrize("case", ["random", "ties", "constant", "zeros",
                                  "with_inf", "extremes"])
@pytest.mark.parametrize("k", [1, 2, 192, 239, 240])
def test_radix_selection_picks_the_k_smallest(case, k):
    """The template kernel's exact selection (`ref.smallest_k_radix`)
    against a sort: the k-th smallest and the count under it are exact,
    so sum(d < v_k) + (k - below) v_k takes the same k values as the
    sort-based oracle, with ties, +inf padding and k at its edges
    (k = round(0.8 T) = 192 at T = 240)."""
    rows, n = _selection_rows(case, np.random.default_rng(k))
    dev = torch.as_tensor(rows)
    kth, below, passes, total = ref.smallest_k_radix(dev, k, n)
    srt = torch.sort(dev, dim=1).values
    assert torch.equal(kth, srt[:, k - 1])
    assert torch.equal(below, (dev < kth[:, None]).sum(1))
    assert bool((below < k).all())
    assert bool((passes <= 31).all())
    kept = torch.where(dev < kth[:, None], dev, torch.zeros_like(dev))
    # the same multiset as the sort: the values under v_k, then v_k
    for r in range(len(rows)):
        pick = torch.cat([torch.sort(dev[r][dev[r] < kth[r]]).values,
                          kth[r].repeat(int(k - below[r]))])
        assert torch.equal(pick, srt[r, :k])
    want = srt[:, :k].double().sum(1)
    np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=1e-5,
                               atol=0)
    assert torch.equal(kept.sum(1) + (k - below).float() * kth, total)


def test_radix_selection_stops_early_on_distinct_values():
    """With distinct deviations the walk stops once one pattern is left,
    well before bit 0; all-tied rows walk all 31 bits."""
    rng = np.random.default_rng(3)
    dev = torch.as_tensor(rng.exponential(1.0, (64, 256)).astype(np.float32))
    assert float(ref.smallest_k_radix(dev, 192)[2].float().mean()) < 20
    assert bool((ref.smallest_k_radix(torch.zeros(2, 256), 192)[2]
                 == 31).all())


def _flat_row():
    """A history row of `generate_population(16000, seed=0)` (VM 947): 239
    slots at 100 and one at 99.66364."""
    row = np.full(240, 100.0, np.float32)
    row[68] = np.float32(99.66364)
    return row


def test_kernel_statistics_round_as_the_plain_version():
    """The template kernel takes the cumsum and the std in float64 (lane
    scans, then the exclusive shuffle scan and butterfly sums) and rounds
    them to float32 once, which is what the plain version computes on the
    CPU: bit-equal on random rows and on a near-flat one. The near-flat
    row shows why it must: an ulp of the cumsum decides whether its
    de-trended series is flat, and Compare8 goes from 1 to 0 when the
    same function is taken in float64 throughout."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(np.concatenate(
        [rng.uniform(0, 100, (63, 240)).astype(np.float32),
         _flat_row()[None]]))
    lanes = torch.nn.functional.pad(x.double(), (0, 16)).reshape(-1, 32, 8)
    part = lanes.cumsum(2)
    excl = torch.cat([torch.zeros_like(part[:, :1, -1]),
                      part[:, :-1, -1].cumsum(1)], 1)
    cs = (excl[:, :, None] + part).reshape(-1, 256)[:, :240].float()
    assert torch.equal(cs, torch.cumsum(x, -1))
    xd = PTS.detrend(x)
    sd = (xd.double() - xd.double().mean(-1, keepdim=True)).pow(2) \
        .mean(-1).sqrt().float()
    assert torch.equal(sd, torch.std(xd, -1, correction=0))
    flat = torch.as_tensor(_flat_row()[None])
    assert float(ref.criticality_scores_ref(flat)[0, 0]) == 1.0
    assert float(ref.criticality_scores_ref(flat.double())[0, 0]) == 0.0
