"""Port forest inference (`repro_torch.kernels.forest`,
`repro_torch.serve.inference`) against the JAX reference, on the CPU.

The bar, from tests/test_kernels.py: leaf indices equal to
`ObliviousForest.leaf_index_np`, probabilities within atol 1e-5 of
`predict_proba_np` and of the Pallas kernel in interpret mode; every
argmax and gated (`*_used`, `conservative`) key of `served_query` equal
to the reference's, confidences within atol 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.core import features as RF  # noqa: E402
from repro.core.forest import (train_gradient_boosting,  # noqa: E402
                               train_random_forest)
from repro.core.predictor import train_service  # noqa: E402
from repro.kernels.forest.ops import forest_predict  # noqa: E402
from repro.sim.telemetry import generate_population  # noqa: E402

from _torch_parity import reference_serve, service_dict  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.forest import ops, ref  # noqa: E402
from repro_torch.serve import inference  # noqa: E402

RNG = np.random.default_rng(0)


@pytest.fixture(scope="module")
def rinf():
    return reference_serve("inference")


@pytest.mark.parametrize("trainer,kind", [(train_random_forest, "rf"),
                                          (train_gradient_boosting, "gb")])
@pytest.mark.parametrize("n_classes", [2, 4])
def test_forest_matches_oracle_and_pallas(trainer, kind, n_classes):
    x = RNG.normal(0, 1, (300, 7)).astype(np.float32)     # 300 % 128 != 0
    y = RNG.integers(0, n_classes, 300)
    y[x[:, 0] > 0] = 0
    f = trainer(x, y, n_classes, n_trees=12, depth=4)
    fi, thr, leaf, t, d, k = ops.pack_forest(f, "cpu")
    xt = torch.as_tensor(x)
    np.testing.assert_array_equal(
        ref.leaf_index_ref(xt, fi[None], thr[None])[:, 0].numpy(),
        f.leaf_index_np(x))
    got = ops.predict_packed(xt, fi, thr, leaf, kind).numpy()
    want = f.predict_proba_np(x)
    pallas = np.asarray(forest_predict(f, x))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), pallas.argmax(-1))


def test_stacked_sums_equal_per_forest():
    """One pass over a (NF, ...) stack equals NF single-forest passes."""
    x = RNG.normal(0, 1, (130, 5)).astype(np.float32)
    packs = [ops.pack_forest(train_random_forest(
        x, RNG.integers(0, 2, 130), 2, n_trees=6, depth=3, seed=s), "cpu")
        for s in range(3)]
    stack = [torch.stack([p[i] for p in packs]) for i in range(3)]
    xt = torch.as_tensor(x)
    both = ops.forest_sums(xt, *stack)
    for j, p in enumerate(packs):
        np.testing.assert_array_equal(
            both[:, j].numpy(),
            ops.forest_sums(xt, p[0][None], p[1][None], p[2][None])[:, 0]
            .numpy())


def _truncate_high(svc, n):
    """A service whose high-bucket forest is smaller than the others, so
    the four cannot be stacked."""
    h = svc.p95.high
    high = dataclasses.replace(h, feat_idx=h.feat_idx[:n],
                               thresholds=h.thresholds[:n],
                               leaf_values=h.leaf_values[:n])
    return dataclasses.replace(svc, p95=dataclasses.replace(svc.p95,
                                                            high=high))


@pytest.fixture(scope="module", params=["rf", "gb"])
def served(request):
    pop = generate_population(600, seed=0)
    hist, arrivals = RF.split_history_arrivals(pop)
    labels = hist.labels.astype(np.int64)
    aggs = RF.subscription_aggregates(hist, labels)
    svc = train_service(RF.build_features(hist, aggs), labels,
                        RF.p95_bucket([v.p95_util for v in hist.vms]),
                        model=request.param, n_trees=12)
    return svc, RF.build_features(arrivals, aggs)


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("jax_kernel", ["ref", "pallas_interpret"])
def test_served_query_matches_reference(rinf, served, stacked, jax_kernel):
    svc, x = served
    if not stacked:
        svc = _truncate_high(svc, 7)
    packed_j, meta_j = rinf.pack_service(svc)
    want = rinf.served_query(packed_j, meta_j, jnp.asarray(x),
                             kernel=jax_kernel)
    packed, meta = inference.pack_service(
        convert.service_from_numpy(service_dict(svc)), "cpu")
    assert (packed.stacked is not None) == stacked
    got = inference.served_query(packed, meta, torch.as_tensor(x))
    assert len(x) % 128
    for k in ("workload_type", "p95_bucket", "workload_type_used",
              "p95_bucket_used", "conservative"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("workload_conf", "p95_conf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)


def test_bucket_to_p95_matches_reference(rinf):
    b = np.array([0, 1, 2, 3, 3, 0], np.int32)
    np.testing.assert_array_equal(
        inference.bucket_to_p95_torch(torch.as_tensor(b)).numpy(),
        np.asarray(rinf.bucket_to_p95_jnp(jnp.asarray(b))))
