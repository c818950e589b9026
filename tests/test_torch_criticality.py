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


@pytest.mark.parametrize("days", [5, 10])
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


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ops.criticality_scores(torch.ones(3, 50))
    with pytest.raises(ValueError):
        ops.criticality_scores(torch.ones(240))
