"""The port's labeling-and-serving slice as a whole, against the JAX
reference, on the CPU: label a history, carry the JAX
`PredictionService` and `SubscriptionTable` across through
`repro_torch.convert`, build both `ServePipeline.from_history`, serve,
depart some arrivals and serve again. Every decision column must be
equal; the featurizer and table must match the reference.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.core import features as RF  # noqa: E402
from repro.core.criticality import classify as r_classify  # noqa: E402
from repro.core.predictor import train_service  # noqa: E402
from repro.core.resources import ResourceVector as RVector  # noqa: E402
from repro.sim.telemetry import (arrival_batch,  # noqa: E402
                                 generate_population)

from _torch_parity import (reference_serve, service_dict,  # noqa: E402
                           table_dict)
from repro_torch import convert  # noqa: E402
from repro_torch.core import criticality as PC  # noqa: E402
from repro_torch.serve import (FAIL_POWER, PlaneBundle,  # noqa: E402
                               ResourceVector, ServeConfig, ServePipeline,
                               featurize_batch, p95_bucket_torch,
                               table_from_history, update_table)

BUDGET_W = 12 * 112.0 + 60.0 * 4.95          # per chassis, rho ceiling 60


@pytest.fixture(scope="module")
def rserve():
    return reference_serve()


@pytest.fixture(scope="module")
def world(rserve):
    pop = generate_population(600, seed=0)
    hist, arrivals = RF.split_history_arrivals(pop)
    labels = np.asarray(r_classify(jnp.asarray(hist.series)))
    p_labels = PC.classify(hist.series, device="cpu").numpy()
    np.testing.assert_array_equal(p_labels, labels)
    aggs = RF.subscription_aggregates(hist, labels)
    svc = train_service(RF.build_features(hist, aggs),
                        labels.astype(np.int64),
                        RF.p95_bucket([v.p95_util for v in hist.vms]),
                        n_trees=12)
    cap = max(v.subscription for v in pop.vms) + 8
    table = rserve.table_from_history(hist, labels, cap)
    return dict(hist=hist, arrivals=arrivals, labels=labels, aggs=aggs,
                svc=svc, table=table, cap=cap)


def test_table_from_history_matches_reference(world):
    got = table_from_history(world["hist"], world["labels"], world["cap"],
                             device="cpu")
    for f, a, b in zip(got._fields, got, world["table"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   err_msg=f)


def test_featurizer_matches_reference(world, rserve):
    table = convert.table_from_numpy(table_dict(world["table"]), "cpu")
    batch = arrival_batch(world["arrivals"])
    got = featurize_batch(table, batch, pad_to=len(batch) + 5).numpy()
    want = np.asarray(rserve.featurize_batch(world["table"], batch,
                                             pad_to=len(batch) + 5))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got[:len(batch)], RF.build_features(world["arrivals"], world["aggs"]),
        atol=1e-4)


def test_out_of_range_ids_fall_back_and_drop(world, rserve):
    table = convert.table_from_numpy(table_dict(world["table"]), "cpu")
    cap = table.capacity
    b = arrival_batch(world["arrivals"], [0, 1])
    b.subscription[:] = [cap + 5, -3]
    got = featurize_batch(table, b).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(rserve.featurize_batch(world["table"], b)))
    assert got[0, 0] == pytest.approx(RF._DEFAULT_AGG["pct_uf"])
    t2 = update_table(table, torch.tensor([cap + 5, -3, 2]), torch.ones(3),
                      torch.full((3,), 200.0), torch.full((3,), 50.0),
                      torch.full((3,), 30.0))
    j2 = rserve.update_table(world["table"], jnp.asarray([cap + 5, -3, 2]),
                             jnp.ones(3), jnp.full(3, 200.0),
                             jnp.full(3, 50.0), jnp.full(3, 30.0))
    for f, a, w in zip(t2._fields, t2, j2):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w), err_msg=f)


def test_p95_bucket_boundaries(rserve):
    from repro.serve.featurizer import p95_bucket_jnp
    vals = np.array([0.0, 1.0, 24.999, 25.0, 25.001, 50.0, 74.5, 75.0,
                     99.0, 100.0], np.float32)
    np.testing.assert_array_equal(
        p95_bucket_torch(torch.as_tensor(vals)).numpy(),
        np.asarray(p95_bucket_jnp(jnp.asarray(vals))))


def _assert_results_equal(got, want):
    for f in ("server", "workload_type", "p95_bucket", "conservative",
              "p95_eff"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("budget", [None, BUDGET_W])
def test_serve_slice_matches_reference(world, rserve, budget):
    kw = dict(n_servers=36, cores_per_server=40, blades_per_chassis=12)
    r_pipe = rserve.ServePipeline.from_history(
        world["svc"], world["hist"], world["labels"],
        table_capacity=world["cap"],
        config=rserve.ServeConfig(kernel="ref", planes=rserve.PlaneBundle(
            chassis_budget=None if budget is None else RVector(watts=budget))),
        **kw)
    p_pipe = ServePipeline.from_history(
        convert.service_from_numpy(service_dict(world["svc"])),
        world["hist"], world["labels"], table_capacity=world["cap"],
        config=ServeConfig(planes=PlaneBundle(
            chassis_budget=None if budget is None
            else ResourceVector(watts=budget))),
        device="cpu", **kw)
    # the slice's contract: the reference's table, carried across
    p_pipe.table = convert.table_from_numpy(table_dict(r_pipe.table), "cpu")
    batch = arrival_batch(generate_population(256, seed=7))
    want, got = r_pipe.serve(batch), p_pipe.serve(batch)
    _assert_results_equal(got, want)
    if budget is not None:
        assert got.n_power_rejected > 0
        assert (got.server == FAIL_POWER).sum() == want.n_power_rejected
    # depart every other admitted VM, then serve a second, ragged batch
    adm = np.flatnonzero(got.admitted)[::2]
    args = (got.server[adm], batch.cores[adm], got.p95_eff[adm],
            got.workload_type[adm] == 1)
    r_pipe.depart(*map(jnp.asarray, args))
    p_pipe.depart(*args)
    np.testing.assert_array_equal(p_pipe.state.free_cores.numpy(),
                                  np.asarray(r_pipe.state.free_cores))
    batch2 = arrival_batch(generate_population(300, seed=8))
    _assert_results_equal(p_pipe.serve(batch2), r_pipe.serve(batch2))


def test_hot_swap_and_observe(world, rserve):
    svc = convert.service_from_numpy(service_dict(world["svc"]))
    pipe = ServePipeline.from_history(
        svc, world["hist"], world["labels"], n_servers=36,
        cores_per_server=40, blades_per_chassis=12,
        table_capacity=world["cap"], device="cpu")
    batch = arrival_batch(world["arrivals"], np.arange(40))
    before = pipe._buffers[pipe._active]
    pipe.hot_swap(svc)
    assert pipe.swaps == 1 and pipe._buffers[pipe._active] is not before
    pipe.observe(world["hist"], world["labels"])
    np.testing.assert_array_equal(
        pipe.table.count.numpy(),
        2 * np.asarray(world["table"].count))
    assert pipe.serve(batch).server.shape == (40,)


@pytest.mark.parametrize("plane", ["cluster_budget", "emergency", "adaptive",
                                   "ballooning", "obs"])
def test_unported_planes_raise(plane):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PlaneBundle(**{plane: object()})
