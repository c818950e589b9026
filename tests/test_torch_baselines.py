"""The port's Table II baselines (`repro_torch.core.baselines`), Table III
metrics (`core.predictor.table3_metrics`) and the operator CLI
(`launch.oversubscribe`) against the JAX package's, on the CPU.

The baseline scores are O(1) and go through the port's `preprocess`,
whose float32 cumsum differs from JAX's blocked one (ROADMAP Queue 3), so
they are held at rtol 1e-3 with atol 2e-5 for scores near zero (measured:
up to 1.1e-6 absolute for FFT, 7.6e-6 for ACF, at 1,000 VMs), and the
precision each baseline reaches at recall 0.9 within 0.01 of the
reference's. `precision_at_recall`, `table3_metrics` and the CLI are host
numpy copies, so they must give equal results.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import baselines as RB
from repro.core import features as RF
from repro.core import predictor as RPred
from repro.launch import oversubscribe as RCLI
from repro.sim.telemetry import generate_population
from repro_torch.core import baselines as B
from repro_torch.core import features as F
from repro_torch.core import predictor as PPred
from repro_torch.launch import oversubscribe as CLI


@pytest.fixture(scope="module")
def pop():
    return generate_population(1000, seed=3)


@pytest.mark.parametrize("name", ["fft_score", "acf_score"])
def test_baseline_scores_match_reference(pop, name):
    series = pop.series.astype(np.float32)
    want = np.asarray(getattr(RB, name)(jnp.asarray(series)))
    got = getattr(B, name)(series, device="cpu")
    assert got.shape == want.shape and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-5)
    prec, rec, _ = B.precision_at_recall(got, pop.labels, 0.9)
    rprec, rrec, _ = RB.precision_at_recall(want, pop.labels, 0.9)
    assert rec >= 0.9 and abs(prec - rprec) <= 0.01


@pytest.mark.parametrize("target", [0.5, 0.9, 0.99, 1.0, 1.5])
def test_precision_at_recall_equals_reference(target):
    rng = np.random.default_rng(7)
    scores = rng.normal(size=500)
    scores[::7] = scores[0]                          # ties
    labels = rng.random(500) < 0.4
    assert B.precision_at_recall(scores, labels, target) == \
        RB.precision_at_recall(scores, labels, target)


def test_table3_metrics_equal_reference():
    """Train the service with each package's (array-equal) trainer on one
    population and score the arrivals: every Table III number is
    equal."""
    pop = generate_population(900, seed=1)
    hist, arr = RF.split_history_arrivals(pop)
    labels = hist.labels.astype(np.int64)
    aggs = RF.subscription_aggregates(hist, labels)
    x = RF.build_features(hist, aggs)
    np.testing.assert_array_equal(F.build_features(hist, aggs), x)
    buckets = RF.p95_bucket([v.p95_util for v in hist.vms])
    xa = RF.build_features(arr, aggs)
    ya = arr.labels.astype(np.int64)
    ba = RF.p95_bucket([v.p95_util for v in arr.vms])
    for model in ("rf", "gb"):
        want = RPred.table3_metrics(
            RPred.train_service(x, labels, buckets, model, n_trees=12),
            xa, ya, ba)
        got = PPred.table3_metrics(
            PPred.train_service(x, labels, buckets, model, n_trees=12),
            xa, ya, ba)
        assert got == want, model
        assert 0.0 < got["p95"]["pct_high_conf"] <= 1.0


@pytest.mark.parametrize("argv", [
    ["--chassis", "16", "--days", "5"],
    ["--chassis", "12", "--days", "4", "--scenario", "state_of_the_art",
     "--beta", "0.5", "--seed", "3"],
    ["--chassis", "8", "--days", "3", "--scenario",
     "predictions_no_uf_impact", "--servers-per-chassis", "10"],
])
def test_cli_budget_equals_reference(argv, capsys):
    got = CLI.main(argv)
    out_port = capsys.readouterr().out
    want = RCLI.main(argv)
    out_ref = capsys.readouterr().out
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert out_port == out_ref


def test_cli_reads_draws_file(tmp_path, capsys):
    draws = np.random.default_rng(0).uniform(1500.0, 3500.0, (6, 400))
    path = tmp_path / "draws.npy"
    np.save(path, draws)
    got = CLI.main(["--draws", str(path), "--chassis", "6"])
    want = RCLI.main(["--draws", str(path), "--chassis", "6"])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert "synthetic" not in capsys.readouterr().out
