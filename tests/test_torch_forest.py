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


@pytest.mark.parametrize("trainer,kind", [(train_random_forest, "rf"),
                                          (train_gradient_boosting, "gb")])
def test_forest_predict_matches_reference(trainer, kind):
    """The package's public call, `repro_torch.kernels.forest.
    forest_predict`, against the reference's (its Pallas kernel in
    interpret mode) at the bar of tests/test_kernels.py, on arrays and on
    tensors."""
    from repro_torch.kernels.forest import forest_predict as port_predict
    from repro_torch.core.forest import ObliviousForest
    x = RNG.normal(0, 1, (300, 7)).astype(np.float32)
    y = RNG.integers(0, 3, 300)
    y[x[:, 0] > 0.3] = 0
    f = trainer(x, y, 3, n_trees=12, depth=4)
    pf = ObliviousForest(*(getattr(f, k) for k in (
        "feat_idx", "thresholds", "leaf_values", "kind", "n_features")))
    want = np.asarray(forest_predict(f, x))
    got = port_predict(pf, x, device="cpu")
    assert got.shape == (300, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), f.predict_proba_np(x), atol=1e-5)
    again = port_predict(pf, torch.as_tensor(x), device="cpu")
    assert torch.equal(again, got)


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


def _random_forest(rng, t, d, k, n_features=18, kind="rf"):
    """A reference `ObliviousForest` with seeded random tables."""
    from repro.core.forest import ObliviousForest
    return ObliviousForest(
        feat_idx=rng.integers(0, n_features, (t, d)).astype(np.int32),
        thresholds=rng.normal(0, 1, (t, d)).astype(np.float32),
        leaf_values=rng.uniform(0, 1, (t, 1 << d, k)).astype(np.float32),
        kind=kind, n_features=n_features)


@pytest.mark.parametrize("t", [1, 33, 48, 100, 256, 400, 1000, 5000])
def test_launch_plan_takes_every_stack(t):
    """The kernel's launch plan covers every (T, D, K) the Pallas
    kernel takes (the first design refused T = 100 at D = 6 and K > 8):
    trees tiled in multiples of 32 whose nodes fit the node tile, shared
    memory within 48 KB, every output in a chunk."""
    for d in (1, 6, 8, 12, 20, 31):
        for k in (1, 2, 3, 10, 64):
            for b, nf in [(1, 1), (256, 4), (65536, 4)]:
                p = ops.launch_plan(b, 18, nf, t, d, k)
                assert p["tile"] % 32 == 0 and p["tile"] >= 32
                assert p["tile"] * d <= ops.NODE_WORDS
                assert p["lanes"] in (8, 16, 32)
                assert p["rows"] % (ops.WARPS * 32 // p["lanes"]) == 0
                assert p["smem"] <= 48 * 1024
                assert p["kc"] in (1, 2, 4, 8) and p["kc"] >= min(k, 8)
                assert p["grid"] == (-(-b // p["rows"]), nf)


def test_launch_plan_fills_the_card_and_refuses_only_past_depth_31():
    serving = ops.launch_plan(256, 18, 4, 48, 6, 2)
    assert serving["grid"][0] * serving["grid"][1] >= 132
    assert serving["stage_x"] and serving["tile"] == 64
    assert serving["lanes"] == 32           # 16 would leave SMs idle
    scoring = ops.launch_plan(65536, 18, 4, 48, 6, 2)
    assert scoring["grid"][0] * scoring["grid"][1] >= 2 * 132
    assert scoring["lanes"] == 8            # 6 trees a lane, 4 rows a step
    assert ops.launch_plan(600, 18, 4, 48, 6, 2)["lanes"] == 16
    assert not ops.launch_plan(8, 5000, 1, 48, 6, 2)["stage_x"]
    with pytest.raises(ValueError, match="depth"):
        ops.launch_plan(256, 18, 4, 48, 32, 2)


@pytest.mark.parametrize("t,d,k", [(100, 6, 2), (256, 6, 2), (48, 1, 2),
                                   (48, 8, 2), (48, 6, 1), (48, 6, 4),
                                   (48, 6, 10), (33, 3, 2), (400, 12, 2)])
def test_lane_order_matches_reference(t, d, k):
    """The kernel's summation orders (`ref.forest_sums_lanes` at the
    launch plan's tree tile and 32, 16 or 8 lanes a row; T = 400 at
    D = 12 takes two tiles) against
    the JAX Pallas kernel in interpret mode (the numpy oracle for the
    two-tile stack, whose one-hot scratch would not fit a CPU test)
    within 1e-5 per tree, with leaf indices exact."""
    rng = np.random.default_rng(t * 100 + d * 10 + k)
    f = _random_forest(rng, t, d, k)
    x = rng.normal(0, 1, (300, 18)).astype(np.float32)
    fi, thr, leaf, *_ = ops.pack_forest(f, "cpu")
    xt = torch.as_tensor(x)
    np.testing.assert_array_equal(
        ref.leaf_index_ref(xt, fi[None], thr[None])[:, 0].numpy(),
        f.leaf_index_np(x))
    tile = ops.launch_plan(300, 18, 1, t, d, k)["tile"]
    assert (tile < t) == (t == 400)                 # two tree tiles
    if t * (1 << d) <= 2 ** 14:
        want = np.asarray(forest_predict(f, x))
    else:
        want = f.predict_proba_np(x)
    for lanes in (32, 16, 8):
        got = ref.forest_sums_lanes(xt, fi[None], thr[None], leaf[None],
                                    tile=tile, lanes=lanes)[:, 0].numpy()
        np.testing.assert_allclose(got / t, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("jax_kernel", ["ref", "pallas_interpret"])
def test_served_query_in_lane_order_matches_reference(rinf, served,
                                                      jax_kernel,
                                                      monkeypatch):
    """The seeded serve with the four forests summed in the kernel's
    order: sums within 1e-5 per tree of the plain version, and every
    gated key of `served_query` equal to the reference's."""
    svc, x = served
    packed, meta = inference.pack_service(
        convert.service_from_numpy(service_dict(svc)), "cpu")
    xt = torch.as_tensor(x)
    nf, t, d = packed.stacked.feat_idx.shape
    plan = ops.launch_plan(len(x), x.shape[1], nf, t, d,
                           packed.stacked.leaf.shape[-1])
    lanes = ref.forest_sums_lanes(xt, *packed.stacked, tile=plan["tile"],
                                  lanes=plan["lanes"])
    plain = ref.forest_sums_ref(xt, *packed.stacked)
    assert float((lanes - plain).abs().max()) / t <= 1e-5
    monkeypatch.setattr(
        ref, "forest_sums_ref",
        lambda *a: ref.forest_sums_lanes(*a, tile=plan["tile"],
                                         lanes=plan["lanes"]))
    got = inference.served_query(packed, meta, xt)
    packed_j, meta_j = rinf.pack_service(svc)
    want = rinf.served_query(packed_j, meta_j, jnp.asarray(x),
                             kernel=jax_kernel)
    for k in ("workload_type", "p95_bucket", "workload_type_used",
              "p95_bucket_used", "conservative"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("workload_conf", "p95_conf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)


def test_stack_checks_refuse_what_the_kernel_cannot_take():
    """`check_stack` (run once per model by `pack_service`, and by
    `forest_sums` unless the stack was checked) refuses a broken stack."""
    fi = torch.zeros((2, 3, 4), dtype=torch.int32)
    thr = torch.zeros((2, 3, 4))
    leaf = torch.zeros((2, 3, 16, 2))
    ops.check_stack(fi, thr, leaf)
    for bad in [(fi, thr[:, :2], leaf), (fi, thr, leaf[:, :, :8]),
                (fi.long(), thr, leaf), (fi, thr.double(), leaf),
                (fi, thr, leaf.transpose(2, 3).contiguous().transpose(2, 3))]:
        with pytest.raises(ValueError):
            ops.check_stack(*bad)
    with pytest.raises(ValueError):
        ops.forest_sums(torch.zeros(5, 18), fi.long(), thr, leaf)
    with pytest.raises(ValueError):
        ops.forest_sums(torch.zeros(5), fi, thr, leaf)
