"""Port host substrate (numpy carried into `repro_torch`) against the
reference: the same seed must give array-equal populations, features,
arrival batches and trained forests."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import features as RF  # noqa: E402
from repro.core import placement as RP  # noqa: E402
from repro.core import power_model as RPM  # noqa: E402
from repro.core import predictor as RPR  # noqa: E402
from repro.sim import telemetry as RT  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import features as PF  # noqa: E402
from repro_torch.core import placement as PP  # noqa: E402
from repro_torch.core import power_model as PPM  # noqa: E402
from repro_torch.core import predictor as PPR  # noqa: E402
from repro_torch.sim import telemetry as PT  # noqa: E402


@pytest.fixture(scope="module")
def pops():
    return (RT.generate_population(600, seed=3),
            PT.generate_population(600, seed=3))


def test_generate_population_array_equal(pops):
    ref, port = pops
    assert len(ref.vms) == len(port.vms)
    np.testing.assert_array_equal(port.series, ref.series)
    np.testing.assert_array_equal(port.labels, ref.labels)
    for f in ("subscription", "klass", "cores", "memory_gb", "vm_type",
              "lifetime_hours", "avg_util", "p95_util"):
        assert [getattr(v, f) for v in port.vms] == \
            [getattr(v, f) for v in ref.vms], f


def test_arrival_batch_array_equal(pops):
    ref, port = pops
    a, b = RT.arrival_batch(ref), PT.arrival_batch(port)
    for f in RT.ArrivalBatch.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert getattr(b, f).dtype == getattr(a, f).dtype


def test_build_features_array_equal(pops):
    ref, port = pops
    rh, ra = RF.split_history_arrivals(ref)
    ph, pa = PF.split_history_arrivals(port)
    labels = rh.labels.astype(np.float64)
    want = RF.build_features(ra, RF.subscription_aggregates(rh, labels))
    got = PF.build_features(pa, PF.subscription_aggregates(ph, labels))
    np.testing.assert_array_equal(got, want)
    assert PF.FEATURE_NAMES == RF.FEATURE_NAMES
    np.testing.assert_array_equal(
        PF.p95_bucket([v.p95_util for v in ph.vms]),
        RF.p95_bucket([v.p95_util for v in rh.vms]))


@pytest.mark.parametrize("model", ["rf", "gb"])
def test_train_service_forests_array_equal(pops, model):
    ref, port = pops
    rh, _ = RF.split_history_arrivals(ref)
    ph, _ = PF.split_history_arrivals(port)
    labels = rh.labels.astype(np.int64)
    x_r = RF.build_features(rh, RF.subscription_aggregates(rh, labels))
    x_p = PF.build_features(ph, PF.subscription_aggregates(ph, labels))
    buckets = RF.p95_bucket([v.p95_util for v in rh.vms])
    want = RPR.train_service(x_r, labels, buckets, model=model, n_trees=12)
    got = PPR.train_service(x_p, labels, buckets, model=model, n_trees=12)
    pairs = [(got.criticality, want.criticality),
             (got.p95.stage1, want.p95.stage1),
             (got.p95.low, want.p95.low), (got.p95.high, want.p95.high)]
    for g, w in pairs:
        for f in ("feat_idx", "thresholds", "leaf_values"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert (g.kind, g.n_features) == (w.kind, w.n_features)
    q_got, q_want = got.query(x_p), want.query(x_r)
    for k in q_want:
        np.testing.assert_array_equal(q_got[k], q_want[k])


def test_cluster_state_oracle_equal():
    rng = np.random.default_rng(1)
    kw = dict(n_servers=24, cores_per_server=40,
              chassis_of_server=np.arange(24) // 8, n_chassis=3)
    ref, port = RP.ClusterState(**kw), PP.ClusterState(**kw)
    pol_r, pol_p = RP.SchedulerPolicy(), PP.SchedulerPolicy()
    for _ in range(80):
        cores, uf = int(rng.choice([1, 2, 4, 8])), bool(rng.random() < 0.5)
        p95 = float(rng.uniform(0.05, 1.0))
        s_r, s_p = pol_r.choose(ref, cores, uf), pol_p.choose(port, cores, uf)
        assert s_r == s_p
        if s_r is not None:
            ref.place(s_r, cores, p95, uf)
            port.place(s_p, cores, p95, uf)
    fields = ("free_cores", "gamma_uf", "gamma_nuf", "rho_peak", "rho_max")
    for f in fields:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    carried = convert.cluster_state_from_numpy(
        {**kw, **{f: getattr(ref, f) for f in fields}})
    for f in fields:
        np.testing.assert_array_equal(getattr(carried, f), getattr(ref, f))
    assert pol_p.choose(carried, 4, True) == pol_r.choose(ref, 4, True)


def test_power_model_equal():
    m_r, m_p = RPM.ServerPowerModel(), PPM.ServerPowerModel()
    f = PPM.pstate_frequencies()
    np.testing.assert_array_equal(f, RPM.pstate_frequencies())
    np.testing.assert_array_equal(PPM.dyn_scale(f), RPM.dyn_scale(f))
    for u in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(PPM.freq_power_curve(m_p, u)[1],
                                      RPM.freq_power_curve(m_r, u)[1])
