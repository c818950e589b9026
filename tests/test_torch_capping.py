"""The port's capping controllers, watt apportionment, framework power
control, oversubscription strategy and the telemetry/resource helpers
they read, against the JAX package on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import capping as RCAP
from repro.core import oversubscription as ROV
from repro.core import resources as RRES
from repro.core.power_model import ServerPowerModel as RModel
from repro.runtime import power_control as RPC
from repro.sim import telemetry as RTEL

from repro_torch.core import capping as CAP
from repro_torch.core import oversubscription as OV
from repro_torch.core import resources as RES
from repro_torch.core.power_model import ServerPowerModel
from repro_torch.runtime import power_control as PC
from repro_torch.sim import telemetry as TEL

FLOORS = np.array([10, 5], np.int32)


def _cases():
    """(cut, dyn) rows: a small cut level 0 absorbs, a cut past both
    floors (leftover), zero-draw rows, an all-critical chassis (only
    level 1 draws), a negative cut, and random rows."""
    fr = RCAP.reducible_fracs()
    rng = np.random.default_rng(4)
    cut = np.concatenate([[0.5 * 100.0 * fr[10],
                           100.0 * fr[10] + 200.0 * fr[5] + 50.0, 30.0,
                           40.0, -3.0], rng.uniform(0, 150, 11)])
    dyn = np.concatenate([[[100.0, 200.0], [100.0, 200.0], [0.0, 0.0],
                           [0.0, 180.0], [50.0, 50.0]],
                          rng.uniform(0, 200, (11, 2))])
    return cut, dyn


@pytest.mark.parametrize("blind", [False, True])
def test_apportion_watts_matches_reference(blind):
    """numpy and torch apportionment equal the reference's numpy call
    (p-states, takes, leftover), in float64 and float32."""
    cut, dyn = _cases()
    for dt in (np.float64, np.float32):
        want = RCAP.apportion_watts(cut.astype(dt), dyn.astype(dt), FLOORS,
                                    np, blind=blind)
        got = CAP.apportion_watts(cut.astype(dt), dyn.astype(dt), FLOORS,
                                  blind=blind)
        tgot = CAP.apportion_watts_torch(torch.as_tensor(cut.astype(dt)),
                                         torch.as_tensor(dyn.astype(dt)),
                                         FLOORS, blind=blind)
        for a, t, w in zip(got, tgot, want):
            np.testing.assert_array_equal(a, w)
            np.testing.assert_array_equal(t.numpy(), w)
        assert tgot[0].dtype == torch.int32
    np.testing.assert_array_equal(CAP.reducible_fracs(),
                                  RCAP.reducible_fracs())
    ctrl = CAP.PerVMController(ServerPowerModel(), 230.0)
    rctrl = RCAP.PerVMController(RModel(), 230.0)
    for a, w in zip(ctrl.apportion(cut, dyn, blind=blind),
                    rctrl.apportion(cut, dyn, blind=blind)):
        np.testing.assert_array_equal(a, w)


def _state_pair(mod, n_uf=20, n_nuf=20):
    return mod.ServerCapState(
        n_uf + n_nuf,
        np.concatenate([np.ones(n_uf, bool), np.zeros(n_nuf, bool)]))


def _assert_state_equal(a, b):
    np.testing.assert_array_equal(a.freq, b.freq)
    np.testing.assert_array_equal(a.pstate, b.pstate)
    assert (a.capping, a.rapl_active, a.clear_since_s) == \
        (b.capping, b.rapl_active, b.clear_since_s)


def test_controllers_step_for_step():
    """PerVMController (alert on, then off until the cap lifts) with the
    RaplController backstop, as `tests/test_capping.py` drives them:
    every step's power and state equal the reference's."""
    rng = np.random.default_rng(0)
    st, rst = _state_pair(CAP), _state_pair(RCAP)
    ctrl = CAP.PerVMController(ServerPowerModel(), 225.0)
    rctrl = RCAP.PerVMController(RModel(), 225.0)
    rapl = CAP.RaplController(ServerPowerModel(), 225.0)
    rrapl = RCAP.RaplController(RModel(), 225.0)
    for i in range(400):
        alert = i < 250
        util = np.concatenate([rng.uniform(0.3, 0.9, 20),
                               np.full(20, 1.0 if alert else 0.3)])
        p = ctrl.step(st, util, alert)
        assert p == rctrl.step(rst, util, alert)
        if p > ctrl.budget:
            assert rapl.step(st, util) == rrapl.step(rst, util)
        _assert_state_equal(st, rst)
    assert not st.capping
    assert CAP.RaplController.backstop_pstate() == \
        RCAP.RaplController.backstop_pstate()


def test_chassis_manager_matches_reference():
    mgr, rmgr = CAP.ChassisManager(1860.0), RCAP.ChassisManager(1860.0)
    draws = np.array([1700.0, 1804.2, 1900.0])
    np.testing.assert_array_equal(mgr.poll(draws), rmgr.poll(draws))
    assert (mgr.alert_w, mgr.target_w, mgr.alert_threshold_w) == \
        (rmgr.alert_w, rmgr.target_w, rmgr.alert_threshold_w)


def _jobs(mod):
    return [mod.JobSpec("serve", cores=16, user_facing=True, p95_util=0.7),
            mod.JobSpec("train", cores=24, user_facing=False, p95_util=1.0)]


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_chassis_power_sim_step_for_step(backend):
    """ChassisPowerSim against the reference's numpy backend, step for
    step: the numpy oracle exactly, the torch step on the CPU to float32
    rounding in power and exactly in the frequencies it sets."""
    kw = {"device": "cpu"} if backend == "torch" else {}
    sim = PC.ChassisPowerSim(budget_w=260.0, backend=backend, **kw)
    ref = RPC.ChassisPowerSim(budget_w=260.0, backend="numpy")
    for a, b in zip(_jobs(PC), _jobs(RPC)):
        sim.register(a)
        ref.register(b)
    rng = np.random.default_rng(1)
    for _ in range(120):
        utils = np.concatenate([rng.uniform(0.5, 0.9, 16), np.ones(24)])
        got, want = sim.step(utils), ref.step(utils)
        assert got["alert"] == want["alert"]
        np.testing.assert_array_equal(got["freq"], want["freq"])
        if backend == "numpy":
            assert got["power_w"] == want["power_w"]
        else:
            assert got["power_w"] == pytest.approx(want["power_w"],
                                                   rel=1e-6)
    assert sim.job_frequency("serve") == pytest.approx(1.0)
    assert sim.job_frequency("train") < 1.0
    loop = PC.ThrottledLoop(sim, "train")
    out, info = loop.run_step(lambda x: x + 1, 1)
    assert out == 2 and info["freq"] == sim.job_frequency("train")
    with pytest.raises(KeyError):
        sim.job_slice("missing")
    with pytest.raises(ValueError, match="backend"):
        PC.ChassisPowerSim(budget_w=260.0, backend="jax")


@pytest.fixture(scope="module")
def profiles():
    kw = dict(beta=0.4, util_uf=0.65, util_nuf=0.44, allocated_frac=0.85,
              servers_per_chassis=12)
    return (OV.FleetProfile(model=ServerPowerModel(), **kw),
            ROV.FleetProfile(model=RModel(), **kw))


def _as_dict(res):
    return dataclasses.asdict(res) | {"oversubscription": res.oversubscription,
                                      "savings": res.savings_usd()}


def test_oversubscription_matches_reference(profiles):
    """`generate_chassis_telemetry` array-equal; `compute_budget` (both
    counting rules), `scenario_table` and `joint_chassis_budget` equal
    the reference's on those draws."""
    fleet, rfleet = profiles
    draws = TEL.generate_chassis_telemetry(60, 14, 3720.0, seed=2)
    np.testing.assert_array_equal(
        draws, RTEL.generate_chassis_telemetry(60, 14, 3720.0, seed=2))
    draws = draws.ravel()
    for name, cfg in OV.SCENARIOS.items():
        rcfg = ROV.SCENARIOS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        for full in (False, True):
            assert _as_dict(OV.compute_budget(draws, 3720.0, cfg, fleet,
                                              full_server=full)) == \
                _as_dict(ROV.compute_budget(draws, 3720.0, rcfg, rfleet,
                                            full_server=full))
    got = OV.scenario_table(draws, 3720.0, fleet, beta_internal_only=0.6,
                            beta_non_premium=0.5)
    want = ROV.scenario_table(draws, 3720.0, rfleet, beta_internal_only=0.6,
                              beta_non_premium=0.5)
    assert list(got) == list(want)
    for k in got:
        assert _as_dict(got[k]) == _as_dict(want[k]), k
    cfg = OV.SCENARIOS["predictions_minimal_uf_impact"]
    res, vec = OV.joint_chassis_budget(draws, 3720.0, cfg, fleet, 480, 1920,
                                       core_ratio=1.25, gb_ratio=1.1)
    rres, rvec = ROV.joint_chassis_budget(
        draws, 3720.0, ROV.SCENARIOS["predictions_minimal_uf_impact"],
        rfleet, 480, 1920, core_ratio=1.25, gb_ratio=1.1)
    assert _as_dict(res) == _as_dict(rres)
    assert vec.as_tuple() == rvec.as_tuple()


def test_resource_and_diurnal_helpers_match_reference():
    """`demand_vector`, `trough_ratios`, `lift_caps`, `lift_pool` and
    `diurnal_util` give the reference's arrays."""
    rng = np.random.default_rng(3)
    cores, p95, mem = rng.integers(1, 33, 9), rng.random(9), rng.random(9)
    np.testing.assert_array_equal(RES.demand_vector(cores, p95, mem),
                                  RRES.demand_vector(cores, p95, mem))
    hours = np.linspace(0.0, 72.0, 145)
    np.testing.assert_array_equal(TEL.diurnal_util(hours),
                                  RTEL.diurnal_util(hours))
    u = TEL.diurnal_util(hours)
    np.testing.assert_array_equal(RES.trough_ratios(u),
                                  RRES.trough_ratios(u))
    np.testing.assert_array_equal(RES.trough_ratios(u, 0.6, 0.3, 0.2),
                                  RRES.trough_ratios(u, 0.6, 0.3, 0.2))
    cap = rng.random(5).astype(np.float32)
    for x in (cap, RRES.lift_caps(cap)):
        np.testing.assert_array_equal(RES.lift_caps(x), RRES.lift_caps(x))
    for x in (np.float64(3.0), np.array([1.0, 2.0, 3.0])):
        np.testing.assert_array_equal(RES.lift_pool(x), RRES.lift_pool(x))
