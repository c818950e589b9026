"""The port's scheduler simulation against the JAX package's, on the CPU.

The `event` backend must give the reference's trace and every
`SimMetrics` field exactly (same seed, same random stream, same numpy
rule); the `serve` backend on ``device="cpu"`` must give the same trace
as the event backend and as the reference's serve backend; the power
evaluation must meet the fleet engine's bars against the reference's
numpy oracle.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.placement import SchedulerPolicy as RPolicy
from repro.core.resources import ResourceVector as RVector
from repro.sim import scheduler_sim as RS

from _torch_parity import reference_enable_x64, reference_serve
from repro_torch.core.placement import SchedulerPolicy
from repro_torch.core.resources import ResourceVector
from repro_torch.sim import scheduler_sim as S

TIGHT_W = 12 * 112.0 + 60.0     # ~60 W of dynamic headroom per chassis
#: Emergency budget of the reference's short emergency sims: barely above
#: the static floor, so alarms trip at any occupancy.
BUDGET_TIGHT = 1480.0
EMERGENCY_KW = dict(days=0.1, seed=0, deployments_per_hour=16.0,
                    prefill_core_ratio=0.6)


@pytest.fixture
def ref_serve(monkeypatch):
    """The reference's serve backend, runnable: `repro.serve` imported
    past its DeprecationWarning (the reference `simulate` imports it
    lazily) and its 64-bit context mapped onto the installed jax."""
    reference_serve()
    reference_enable_x64(monkeypatch)


def _assert_metrics_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.measured_crit_accuracy == want.measured_crit_accuracy
    assert got.measured_p95_accuracy == want.measured_p95_accuracy
    assert (got.nuf_throttled_s, got.uf_throttled_s) == \
        (want.nuf_throttled_s, want.uf_throttled_s)


def _run(mod, policy_kw, channel, trace=None, device=None, obs=None,
         **spec):
    pol = (RPolicy if mod is RS else SchedulerPolicy)(**policy_kw)
    kw = {} if mod is RS else {"device": device}
    return mod.simulate(pol, mod.PredictionChannel(channel),
                        mod.SimSpec(**spec), trace=trace, obs=obs, **kw)


EVENT_CASES = [
    (dict(alpha=0.8), "ml", dict(seed=0)),
    (dict(use_power_rule=False), "none", dict(seed=1)),
    (dict(alpha=0.6, use_utilization_predictions=False), "crit_only",
     dict(seed=2)),
    (dict(alpha=0.8), "oracle", dict(seed=3, prefill_core_ratio=0.3)),
]


@pytest.mark.parametrize("policy_kw,channel,spec", EVENT_CASES)
def test_event_backend_matches_reference(policy_kw, channel, spec):
    """Trace and every SimMetrics field equal the reference's."""
    tr_r, tr_p = [], []
    want = _run(RS, policy_kw, channel, tr_r, days=2.0, **spec)
    got = _run(S, policy_kw, channel, tr_p, days=2.0, **spec)
    assert tr_p == tr_r and len(tr_p) > 1000
    _assert_metrics_equal(got, want)


def test_serve_backend_matches_event_and_reference(ref_serve):
    """The serve backend on the CPU places decision for decision as the
    port's event backend and as the reference's serve backend."""
    pol = dict(alpha=0.8)
    tr_e, tr_s, tr_r = [], [], []
    e = _run(S, pol, "ml", tr_e, days=1.0, seed=0)
    s = _run(S, pol, "ml", tr_s, device="cpu", days=1.0, seed=0,
             serve=S.ServeBackendSpec(backend="serve"))
    r = _run(RS, pol, "ml", tr_r, days=1.0, seed=0,
             serve=RS.ServeBackendSpec(backend="serve"))
    assert tr_s == tr_e == tr_r
    _assert_metrics_equal(s, e)
    _assert_metrics_equal(s, r)


@pytest.mark.parametrize("budget", ["watts", "joint_ratchet"])
def test_serve_admission_budget_matches_reference(ref_serve, budget):
    """A tight per-chassis budget power-rejects the same placements as
    in the reference (`tests/test_serve.py`'s admission case); a joint
    (watts, cores, GB) budget with the diurnal ratchet likewise."""
    if budget == "watts":
        kw = dict(admission_budget=TIGHT_W)
    else:
        kw = dict(admission_budget=(TIGHT_W + 60.0, 300.0, 1300.0),
                  diurnal_ratchet=True)

    def spec(mod, vec):
        b = kw["admission_budget"]
        b = vec(watts=b) if budget == "watts" else vec(*b)
        return mod.ServeBackendSpec(
            backend="serve", admission_budget=b,
            diurnal_ratchet=kw.get("diurnal_ratchet", False))
    tr_p, tr_r = [], []
    got = _run(S, dict(alpha=0.8), "ml", tr_p, device="cpu", days=0.5,
               seed=0, serve=spec(S, ResourceVector))
    want = _run(RS, dict(alpha=0.8), "ml", tr_r, days=0.5, seed=0,
                serve=spec(RS, RVector))
    assert tr_p == tr_r
    _assert_metrics_equal(got, want)
    assert -2 in tr_p                       # FAIL_POWER rejections
    if budget == "watts":
        free = _run(S, dict(alpha=0.8), "ml", device="cpu", days=0.5,
                    seed=0, serve=S.ServeBackendSpec(backend="serve"))
        assert free.failure_rate < 0.01
        assert got.failure_rate > 0.2


def test_fig7_sweep_matches_reference():
    got = S.fig7_sweep(alphas=(0.0, 1.0), days=0.5, seed=1)
    want = RS.fig7_sweep(alphas=(0.0, 1.0), days=0.5, seed=1)
    assert list(got) == list(want)
    for k in want:
        _assert_metrics_equal(got[k], want[k])


def test_power_evaluation_matches_reference():
    """`spec.power` over the scheduler's placements: the port's numpy
    oracle equal to the reference's, the torch engine on the CPU within
    the fleet engine's bars (0.5 W, 0.01 RAPL fraction, rtol 1e-3)."""
    kw = dict(days=1.0, seed=0, prefill_core_ratio=0.5)
    want = _run(RS, dict(alpha=0.8), "ml", **kw, power=RS.PowerEvalSpec(
        budget_w=2000.0, chassis=4, duration_s=20.0,
        backend="numpy")).power
    oracle = _run(S, dict(alpha=0.8), "ml", **kw, power=S.PowerEvalSpec(
        budget_w=2000.0, chassis=4, duration_s=20.0, backend="numpy")).power
    got = _run(S, dict(alpha=0.8), "ml", device="cpu", **kw,
               power=S.PowerEvalSpec(budget_w=2000.0, chassis=4,
                                     duration_s=20.0)).power
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(oracle, f.name),
                                      getattr(want, f.name), err_msg=f.name)
    np.testing.assert_array_equal(got.chassis_ids, want.chassis_ids)
    assert want.alert_frac.max() > 0            # the budget binds
    np.testing.assert_allclose(got.power_max_w, want.power_max_w, atol=0.5)
    np.testing.assert_allclose(got.uf_p95_latency, want.uf_p95_latency,
                               rtol=1e-3)
    np.testing.assert_allclose(got.nuf_slowdown, want.nuf_slowdown,
                               rtol=1e-3)
    assert np.abs(got.rapl_engaged_frac
                  - want.rapl_engaged_frac).max() <= 0.01
    assert np.abs(got.alert_frac - want.alert_frac).max() <= 0.01


@pytest.mark.parametrize("backend", ["event", "serve"])
def test_obs_is_accepted_and_decision_neutral(backend):
    """`simulate(..., obs=)` gives the trace and every `SimMetrics` field
    of the run without it, and exports those metrics into its
    registry."""
    from repro_torch.obs import Observability
    from repro_torch.serve.emergency import EmergencyConfig
    obs = Observability.full()
    kw = dict(emergency=EmergencyConfig.from_model(BUDGET_TIGHT,
                                                   dwell_s=3600.0),
              serve=S.ServeBackendSpec(backend=backend), **EMERGENCY_KW)
    tr_on, tr_off = [], []
    on = _run(S, dict(alpha=0.8), "ml", tr_on, device="cpu", obs=obs, **kw)
    off = _run(S, dict(alpha=0.8), "ml", tr_off, device="cpu", **kw)
    assert tr_on == tr_off
    _assert_metrics_equal(on, off)
    v = obs.registry.value
    assert v("sim_placements_total") == on.placements
    assert v("emergency_alarms_total") == on.alarms > 0
    assert obs.quality.n_scored == on.crit_confusion.sum()
    spans = {"emergency"} | ({"place"} if backend == "serve" else set())
    assert spans <= set(obs.tracer.totals())


def test_plane_misconfigurations_raise():
    with pytest.raises(ValueError, match="ballooning requires"):
        S.SimSpec(ballooning=object())
    with pytest.raises(ValueError, match="diurnal_ratchet"):
        S.simulate(SchedulerPolicy(), S.PredictionChannel(), S.SimSpec(
            days=0.1, serve=S.ServeBackendSpec(diurnal_ratchet=True)))


@pytest.mark.parametrize("blind", [False, True])
def test_emergency_plane_matches_reference(ref_serve, blind):
    """`SimSpec.emergency` at the tight budget: the event backend and the
    serve backend on the CPU (whose torch twin is held bit-equal to the
    oracle on every scan) give the reference's trace and every
    `SimMetrics` field, throttled-seconds, alarms and migrations
    included."""
    from repro.serve.emergency import EmergencyConfig as RConfig
    from repro_torch.serve.emergency import EmergencyConfig
    kw = dict(dwell_s=3600.0, criticality_blind=blind)
    got, want = {}, {}
    for backend in ("event", "serve"):
        tr_p, tr_r = [], []
        got[backend] = _run(
            S, dict(alpha=0.8), "ml", tr_p, device="cpu",
            emergency=EmergencyConfig.from_model(BUDGET_TIGHT, **kw),
            serve=S.ServeBackendSpec(backend=backend), **EMERGENCY_KW)
        want[backend] = _run(
            RS, dict(alpha=0.8), "ml", tr_r,
            emergency=RConfig.from_model(BUDGET_TIGHT, **kw),
            serve=RS.ServeBackendSpec(backend=backend), **EMERGENCY_KW)
        assert tr_p == tr_r, backend
        _assert_metrics_equal(got[backend], want[backend])
    _assert_metrics_equal(got["serve"], got["event"])
    m = got["event"]
    assert m.alarms > 0 and m.nuf_throttled_s > 0


def test_aware_beats_blind_at_the_tight_budget():
    """Over one trace, criticality-aware apportionment gives strictly
    fewer critical throttled-seconds than the blind baseline."""
    from repro_torch.serve.emergency import EmergencyConfig
    m = {blind: _run(S, dict(alpha=0.8), "ml", emergency=EmergencyConfig.
                     from_model(BUDGET_TIGHT, dwell_s=3600.0,
                                criticality_blind=blind), **EMERGENCY_KW)
         for blind in (False, True)}
    assert m[False].alarms == m[True].alarms > 0
    assert m[False].uf_throttled_s < m[True].uf_throttled_s
