"""The port's power-emergency plane (`repro_torch.serve.emergency`) and
migration planner (`repro_torch.serve.mitigation`) against the JAX
package's, on the CPU.

The numpy oracle (`*_np`) must be array-equal to the reference's numpy
call on the same inputs, over random loaded chassis, the aware and blind
modes, hysteresis and dwell. The torch twin must be bit-equal to the
oracle in float64 (and, on the CPU, in float32). Migration plans must be
array-equal to the reference's.

The reference's own emergency tests fail collection on the installed jax,
so its modules are imported here through `_torch_parity.reference_serve`.
"""
import numpy as np
import pytest
import torch

from _torch_parity import reference_serve
from repro_torch.core.placement import ClusterState
from repro_torch.serve import emergency as E
from repro_torch.serve import mitigation as M

#: The paper's 2x operating point (12 x 310 W provisioned, budgeted at
#: half) and the reference tests' stress budget just above the static
#: floor.
BUDGET_2X = 12 * 310.0 / 2.0
BUDGET_TIGHT = 1480.0


@pytest.fixture(scope="module")
def re():
    return reference_serve("emergency")


@pytest.fixture(scope="module")
def rm():
    return reference_serve("mitigation")


def _cfgs(re, budget=BUDGET_TIGHT, **kw):
    return (E.EmergencyConfig.from_model(budget, **kw),
            re.EmergencyConfig.from_model(budget, **kw))


def _loaded_state(seed, n_servers=48, per_chassis=12, cores=40, n=260):
    rng = np.random.default_rng(seed)
    st = ClusterState(n_servers=n_servers, cores_per_server=cores,
                      chassis_of_server=np.arange(n_servers) // per_chassis,
                      n_chassis=n_servers // per_chassis)
    for _ in range(n):
        srv = int(rng.integers(0, n_servers))
        c = int(rng.integers(1, 8))
        if st.free_cores[srv] >= c:
            st.place(srv, c, float(rng.uniform(0.2, 1)),
                     bool(rng.random() < 0.5))
    return st


def _chassis_servers(st):
    return np.argsort(st.chassis_of_server, kind="stable").reshape(
        st.n_chassis, -1)


def _equal(a, b, what):
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_tuples_equal(got, want, what):
    for name, a, b in zip(want._fields, got, want):
        _equal(a, b, f"{what}.{name}")


def _trajectory(seed, n_chassis, steps=12):
    """A seeded sample sequence: per step a utilization per chassis, a
    stamp, and a sample mask, with cool stretches so caps hold and lift."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 25.0, steps))
    util = rng.uniform(0.05, 1.0, (steps, n_chassis))
    util[steps // 2:steps // 2 + 3] *= 0.2           # clear, hold, lift
    mask = rng.random((steps, n_chassis)) < 0.7
    return util, t, mask


@pytest.mark.parametrize("blind", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_and_twin_match_reference_over_loaded_states(re, seed, blind):
    """`emergency_step` over a random loaded fleet, step after step: the
    oracle equal to the reference's numpy call, the float64 twin bit-equal
    to the oracle; alarms, holds and lifts all happen."""
    cfg, rcfg = _cfgs(re, BUDGET_2X if seed else BUDGET_TIGHT,
                      criticality_blind=blind, lift_after_s=20.0,
                      dwell_s=15.0)
    st_cs = _loaded_state(seed, n_servers=96, n=900)
    chs = _chassis_servers(st_cs)
    rho = E.chassis_rho_levels_np(st_cs.gamma_nuf, st_cs.gamma_uf, chs)
    _equal(rho, re.chassis_rho_levels(st_cs.gamma_nuf, st_cs.gamma_uf, chs),
           "chassis_rho_levels")
    util, ts, _ = _trajectory(seed, rho.shape[0])
    s_np = E.init_emergency_np(rho.shape[0], dtype=np.float64)
    s_ref = re.init_emergency(rho.shape[0], xp=np, dtype=np.float64)
    s_t = E.init_emergency(rho.shape[0], dtype=torch.float64, device="cpu")
    rho_t = torch.as_tensor(rho)
    seen = np.zeros(3, int)
    for k in range(len(ts)):
        s_np2, o_np = E.emergency_step_np(cfg, s_np, rho, util[k], ts[k])
        s_ref, o_ref = re.emergency_step(rcfg, s_ref, rho, util[k], ts[k],
                                         np)
        s_t, o_t = E.emergency_step(cfg, s_t, rho_t, util[k], ts[k])
        _assert_tuples_equal(s_np2, s_ref, f"oracle state, step {k}")
        _assert_tuples_equal(o_np, o_ref, f"oracle outputs, step {k}")
        _assert_tuples_equal(s_t, s_np2, f"twin state, step {k}")
        _assert_tuples_equal(o_t, o_np, f"twin outputs, step {k}")
        held = (s_np.pstate > 0).any(-1) & ~o_np.alarm
        seen += [o_np.alarm.sum(), (held & (s_np2.pstate > 0).any(-1)).sum(),
                 (held & ~(s_np2.pstate > 0).any(-1)).sum()]
        _equal(E.mitigation_due(cfg, s_t), E.mitigation_due_np(cfg, s_np2),
               "mitigation_due")
        _equal(E.mitigation_due_np(cfg, s_np2),
               re.mitigation_due(rcfg, s_ref, np), "mitigation_due ref")
        s_np = s_np2
    assert (seen > 0).all(), f"alarms, holds, lifts: {seen}"
    _equal(E.throttled_by_level(s_t), re.throttled_by_level(s_ref),
           "throttled_by_level")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_masked_step_twin_bit_equal(re, dtype):
    """The sample-driven step over random masks, through
    `scatter_samples`: the oracle equal to the reference, the twin
    bit-equal to the oracle in the state's dtype."""
    cfg, rcfg = _cfgs(re, dwell_s=10.0)
    tdt = {np.float64: torch.float64, np.float32: torch.float32}[dtype]
    st_cs = _loaded_state(5, n_servers=120, n=1200)
    chs = _chassis_servers(st_cs)
    rho = E.chassis_rho_levels_np(st_cs.gamma_nuf.astype(dtype),
                                  st_cs.gamma_uf.astype(dtype), chs)
    c = rho.shape[0]
    util, ts, mask = _trajectory(7, c, steps=10)
    s_np = E.init_emergency_np(c, dtype=dtype)
    s_ref = re.init_emergency(c, xp=np, dtype=dtype)
    s_t = E.init_emergency(c, dtype=tdt, device="cpu")
    rho_t = torch.as_tensor(rho)
    for k in range(len(ts)):
        ids = np.flatnonzero(mask[k])
        power = E.sampled_power_np(cfg, rho, util[k], np.zeros((c, 2),
                                   np.int32), np.zeros(c, bool))[ids]
        _equal(power, re.sampled_power(rcfg, rho, util[k], np.zeros(
            (c, 2), np.int32), np.zeros(c, bool), np)[ids], "sampled_power")
        stamps = ts[k] + (ids + 1) * 1e-4
        pw, m, t = E.scatter_samples_np(c, ids, power, stamps, dtype)
        for a, b in zip((pw, m, t), re.scatter_samples(c, ids, power, stamps,
                                                       np, dtype)):
            _equal(a, b, "scatter_samples")
        pw_t, m_t, t_t = E.scatter_samples(c, ids, power, stamps, tdt, "cpu")
        _equal(pw_t, pw, "scatter pw")
        _equal(m_t, m, "scatter mask")
        _equal(t_t, t.astype(dtype), "scatter t")
        _equal(E.util_from_power(cfg, rho_t, pw_t),
               E.util_from_power_np(cfg, rho, pw), "util_from_power")
        s_np, o_np = E.masked_step_np(cfg, s_np, rho, pw, m, t)
        s_ref, o_ref = re.masked_step(rcfg, s_ref, rho, pw, m, t, np)
        s_t, o_t = E.masked_step(cfg, s_t, rho_t, pw_t, m_t, t_t)
        _assert_tuples_equal(s_np, s_ref, f"oracle state, step {k}")
        _assert_tuples_equal(o_np, o_ref, f"oracle outputs, step {k}")
        _assert_tuples_equal(s_t, s_np, f"twin state, step {k}")
        _assert_tuples_equal(o_t, o_np, f"twin outputs, step {k}")
    assert o_np.alarm.any() or s_np.throttled_s.sum() > 0
    due = E.mitigation_due_np(cfg, s_np)
    _assert_tuples_equal(E.reset_dwell(s_t, torch.as_tensor(due)),
                         E.reset_dwell_np(s_np, due), "reset_dwell twin")
    _assert_tuples_equal(E.reset_dwell_np(s_np, due),
                         re.reset_dwell(s_ref, due, np), "reset_dwell ref")


@pytest.mark.parametrize("k", [4, 12, 20, 200])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chassis_rho_levels_bit_equal_to_numpy(re, k, dtype):
    """The twin adds the blade columns in numpy's pairwise order: bit-
    equal to the oracle and the reference for short, 12-blade, ragged and
    long chassis (every branch of `_numpy_order_sum`)."""
    rng = np.random.default_rng(k)
    n_servers = 5 * k
    g = (rng.random((2, n_servers)) * 10.0 ** rng.uniform(-3, 3,
                                                          (2, n_servers)))
    g = g.astype({torch.float64: np.float64, torch.float32: np.float32}[
        dtype])
    chs = rng.permutation(n_servers).reshape(5, k)
    want = E.chassis_rho_levels_np(g[0], g[1], chs)
    _equal(want, re.chassis_rho_levels(g[0], g[1], chs, np), "reference")
    _equal(E.chassis_rho_levels(torch.as_tensor(g[0]), torch.as_tensor(g[1]),
                                torch.as_tensor(chs)), want, "twin")


def test_alarm_matches_chassis_manager(re):
    cfg, _ = _cfgs(re, BUDGET_2X)
    mgr = cfg.manager()
    rho = np.array([[10.0, 10.0], [150.0, 150.0], [40.0, 260.0]])
    st, out = E.emergency_step_np(cfg, E.init_emergency_np(
        3, dtype=np.float64), rho, 0.9, 1.0)
    np.testing.assert_array_equal(out.alarm, mgr.poll(out.power_w))
    assert out.alarm.any()
    ok = out.alarm & (out.leftover_w <= 1e-6)
    assert (out.power_after_w[ok] <= cfg.chassis_budget_w + 1e-6).all()
    assert cfg.alert_w == re.EmergencyConfig.from_model(BUDGET_2X).alert_w


def test_hysteresis_throttle_and_dwell(re):
    """The reference tests' scripted cases through the twin: a cleared
    alarm holds the cap for `lift_after_s` and then lifts; the NUF floor
    absorbs a cut without throttling the critical level; a critical-heavy
    chassis comes due after `dwell_s` and a reset clears it."""
    cfg, _ = _cfgs(re, BUDGET_2X, lift_after_s=30.0, dwell_s=20.0)

    def step(st, rho, util, t):
        return E.emergency_step(
            cfg, st, torch.tensor(rho, dtype=torch.float64), util, t)
    st = E.init_emergency(1, dtype=torch.float64, device="cpu")
    st, out = step(st, [[200.0, 200.0]], 0.95, 0.0)
    assert out.alarm[0] and (st.pstate > 0).any()
    st, out = step(st, [[200.0, 200.0]], 0.10, 10.0)
    assert not out.alarm[0] and (st.pstate > 0).any()
    assert float(st.clear_s[0]) == pytest.approx(10.0)
    st, out = step(st, [[200.0, 200.0]], 0.10, 45.0)
    assert not (st.pstate > 0).any() and not st.rapl[0]
    assert torch.isinf(st.clear_s[0])

    st = E.init_emergency(1, dtype=torch.float64, device="cpu")
    st, _ = step(st, [[300.0, 60.0]], 0.60, 0.0)
    assert st.pstate[0, 0] > 0 and st.pstate[0, 1] == 0
    st, _ = step(st, [[300.0, 60.0]], 0.60, 7.0)
    assert E.throttled_by_level(st)[0] == pytest.approx(7.0)
    assert E.throttled_by_level(st)[E.CRIT_UF] == 0.0

    st = E.init_emergency(1, dtype=torch.float64, device="cpu")
    for t in (0.0, 10.0, 25.0):
        st, out = step(st, [[40.0, 400.0]], 0.95, t)
        assert out.alarm[0]
    assert E.mitigation_due(cfg, st)[0]
    st = E.reset_dwell(st, torch.tensor([True]))
    assert not E.mitigation_due(cfg, st)[0]


def test_all_critical_chassis_takes_rapl_past_its_floor(re):
    """A cut beyond the critical floor engages the RAPL backstop, in the
    oracle, the twin and the reference alike."""
    cfg, rcfg = _cfgs(re, BUDGET_2X, alert_fraction=0.5,
                      target_margin_w=BUDGET_2X - 12 * 112.0 - 1.0)
    rho = np.array([[0.0, 300.0]])
    st, out = E.emergency_step_np(cfg, E.init_emergency_np(
        1, dtype=np.float64), rho, 0.9, 0.0)
    assert st.rapl[0] and out.leftover_w[0] > 0
    st_r, out_r = re.emergency_step(rcfg, re.init_emergency(
        1, xp=np, dtype=np.float64), rho, 0.9, 0.0, np)
    _assert_tuples_equal(st, st_r, "state")
    st_t, _ = E.emergency_step(cfg, E.init_emergency(
        1, dtype=torch.float64, device="cpu"), torch.as_tensor(rho), 0.9, 0.0)
    _assert_tuples_equal(st_t, st, "twin")


def _mig_world(mod_live, seed=7):
    """A cluster with one overloaded chassis full of critical VMs and
    headroom elsewhere (the reference tests' migration world)."""
    st = _loaded_state(0, n_servers=48, per_chassis=12, n=0)
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(24):
        srv = int(rng.integers(0, 12))          # chassis 0
        if st.free_cores[srv] < 8:
            continue
        p95 = float(rng.uniform(0.6, 0.95))
        st.place(srv, 8, p95, True)
        rows.append((srv, 8.0, p95, True))
    for _ in range(10):                          # background elsewhere
        srv = int(rng.integers(12, 48))
        p95 = float(rng.uniform(0.2, 0.5))
        st.place(srv, 4, p95, False)
        rows.append((srv, 4.0, p95, False))
    live = mod_live(np.array([r[0] for r in rows], np.int32),
                    np.array([r[1] for r in rows]),
                    np.array([r[2] for r in rows]),
                    np.array([r[3] for r in rows], bool),
                    mem_gb=np.array([r[1] * 4.0 for r in rows]))
    return st, live


@pytest.mark.parametrize("gb", [None, 600.0, 40.0])
@pytest.mark.parametrize("seed", [7, 11])
def test_plan_migrations_matches_reference(re, rm, seed, gb):
    cfg, rcfg = _cfgs(re)
    st, live = _mig_world(M.LiveVMs, seed)
    _, rlive = _mig_world(rm.LiveVMs, seed)
    rho_lv = np.zeros((4, 2))
    np.add.at(rho_lv, (np.asarray(st.chassis_of_server)[live.server],
                       live.is_uf.astype(int)), live.p95_eff * live.cores)
    mem_c = np.bincount(st.chassis_of_server[live.server],
                        weights=live.mem_gb, minlength=4)
    kw = {} if gb is None else dict(mem_chassis=mem_c,
                                    gb_cap=np.full(4, gb))
    due = np.array([True, False, False, False])
    plan = M.plan_migrations(cfg, live, st.chassis_of_server, st.free_cores,
                             rho_lv, 0.9, due, max_moves_per_chassis=4, **kw)
    want = rm.plan_migrations(rcfg, rlive, st.chassis_of_server,
                              st.free_cores, rho_lv, 0.9, due,
                              max_moves_per_chassis=4, **kw)
    for f in want.__dataclass_fields__:
        a, b = getattr(plan, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if gb == 40.0:
        assert len(plan) == 0                   # no chassis holds the GB
        return
    assert len(plan) >= 2 and plan.is_uf.all()
    assert (st.chassis_of_server[plan.src_server] == 0).all()
    assert (st.chassis_of_server[plan.dst_server] != 0).all()
    for a, b in zip(plan.as_events(), want.as_events()):
        for f in b.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for a, b in zip(plan.paired_stamps(5.0), want.paired_stamps(5.0)):
        np.testing.assert_array_equal(a, b)
    assert len(M.plan_migrations(cfg, live, st.chassis_of_server,
                                 st.free_cores, rho_lv, 0.9,
                                 np.zeros(4, bool))) == 0
