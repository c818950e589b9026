"""The port's fleet engine against the JAX package's, on the CPU.

The port's numpy oracle and layout builders must be array-equal to
`repro.sim.fleet`'s; the torch engine (`backend="torch"`, run here with
``device="cpu"``) must meet the reference's own numpy-vs-jax bars
(`tests/test_fleet_engine.py`) against the reference's numpy oracle on
the Fig 4-5 and Fig 6 configurations.
"""
import numpy as np
import pytest
import torch

from repro.core import fleet_dynamics as RD
from repro.sim import chassis_sim as RC
from repro.sim import fleet as R

from repro_torch.core import fleet_dynamics as D
from repro_torch.sim import chassis_sim as C
from repro_torch.sim import fleet as P

DUR = 60.0          # 300 steps: long enough to cover cap/lift episodes
POWER_TOL_W = 0.5           # per-step chassis power agreement
RAPL_FRAC_TOL = 0.01
FIG45 = [(230.0, "per_vm"), (230.0, "rapl"), (210.0, "per_vm")]
RESULT_FIELDS = ("power_w", "min_nuf_freq", "uf_latency", "alert_frac",
                 "rapl_engaged_frac", "uf_p95_latency", "nuf_slowdown")


def _equal(a, b):
    """Every FleetResult field array-equal."""
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def _bars(ref, got):
    """The reference's numpy-vs-jax bars."""
    np.testing.assert_allclose(ref.power_w, got.power_w, atol=POWER_TOL_W)
    np.testing.assert_allclose(ref.min_nuf_freq, got.min_nuf_freq,
                               atol=1e-5)
    assert np.abs(ref.rapl_engaged_frac
                  - got.rapl_engaged_frac).max() <= RAPL_FRAC_TOL
    np.testing.assert_allclose(ref.uf_p95_latency, got.uf_p95_latency,
                               rtol=1e-3)
    np.testing.assert_allclose(ref.nuf_slowdown, got.nuf_slowdown,
                               rtol=1e-3)


def _specs(mod, kind):
    """The Fig 4-5 server or a Fig 6 chassis, from `mod`'s builders."""
    if kind == "server":
        return [mod.paper_single_server_spec()]
    return mod.paper_chassis_specs(kind == "balanced")


CASES = [("server", b, m, 3) for b, m in FIG45] \
    + [("balanced", 2450.0, "per_vm", 4), ("imbalanced", 2450.0, "per_vm", 4)]


@pytest.mark.parametrize("kind,budget,mode,seed", CASES)
def test_engine_parity(kind, budget, mode, seed):
    """Fig 4-5 (three caps and modes) and Fig 6 (both placements): the
    port's oracle array-equal to the reference's, its torch engine within
    the bars."""
    ref = R.run_fleet(_specs(RC, kind), budget, mode, DUR, seed,
                      backend="numpy")
    _equal(ref, P.run_fleet(_specs(C, kind), budget, mode, DUR, seed,
                            backend="numpy"))
    _bars(ref, P.run_fleet(_specs(C, kind), budget, mode, DUR, seed,
                           backend="torch", device="cpu"))


@pytest.mark.parametrize("kind", ["server", "balanced"])
def test_simulate_chassis_matches_reference(kind):
    """The Figs 4-6 adapters: torch on the CPU within the bars of the
    reference's oracle, for one run per mode."""
    specs_r, specs_p = _specs(RC, kind), _specs(C, kind)
    budget = 230.0 if kind == "server" else 2450.0
    for mode in ("none", "rapl", "per_vm"):
        a = RC.simulate_chassis(specs_r, budget, mode, 30.0, 3)
        b = C.simulate_chassis(specs_p, budget, mode, 30.0, 3,
                               device="cpu")
        np.testing.assert_allclose(a.power_w, b.power_w, atol=POWER_TOL_W)
        assert b.uf_p95_latency == pytest.approx(a.uf_p95_latency,
                                                 rel=1e-3)
        assert b.nuf_slowdown == pytest.approx(a.nuf_slowdown, rel=1e-3)
        assert abs(a.rapl_engaged_frac - b.rapl_engaged_frac) \
            <= RAPL_FRAC_TOL
    one = C.simulate_server(specs_p[0], 230.0, "per_vm", 30.0, 3,
                            backend="numpy")
    np.testing.assert_array_equal(
        one.power_w,
        RC.simulate_server(specs_r[0], 230.0, "per_vm", 30.0, 3).power_w)


def _hetero(mod):
    chassis = [
        [mod.ServerSpec(vms=[mod.VMSpec(8, True, load=0.7),
                             mod.VMSpec(24, False)]) for _ in range(3)],
        [mod.ServerSpec(vms=[mod.VMSpec(4, True, load=0.9)] * 2
                        + [mod.VMSpec(10, False)]) for _ in range(3)],
    ]
    return [mod.build_layout(sp, pad_uf_to=6, pad_nuf_to=3)
            for sp in chassis]


def test_layout_builders_array_equal():
    """build_layout (with VM and core padding), arrays(), stack_layouts
    and build_uf_traces give the reference's arrays."""
    pairs = [(R.build_layout(_specs(RC, k)), P.build_layout(_specs(C, k)))
             for k in ("server", "balanced", "imbalanced")]
    pairs.append((R.build_layout(_specs(RC, "server"), pad_cores_to=48),
                  P.build_layout(_specs(C, "server"), pad_cores_to=48)))
    pairs += list(zip(_hetero(R), _hetero(P)))
    for lr, lp in pairs:
        for f in lr.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(lp, f), getattr(lr, f),
                                          err_msg=f)
        for a, b in zip(lp.arrays(pad_uf_cores_to=50),
                        lr.arrays(pad_uf_cores_to=50)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            P.build_uf_traces(lp, 40, 7, 0.8),
            R.build_uf_traces(lr, 40, 7, 0.8))
    for a, b in zip(P.stack_layouts(_hetero(P)),
                    R.stack_layouts(_hetero(R))):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_heterogeneous_layouts_parity():
    """Chassis with different VM placements batch via stacked layout
    arrays: the oracle array-equal, the torch engine within the bars."""
    out = {}
    for name, mod in (("ref", R), ("port", P)):
        layouts = _hetero(mod)
        traces = np.stack([mod.build_uf_traces(lo, int(DUR / 0.2),
                                               seed=9 + i)
                           for i, lo in enumerate(layouts)])
        args = (mod.stack_layouts(layouts),
                np.stack([lo.uf_valid for lo in layouts]),
                np.stack([lo.nuf_valid for lo in layouts]),
                np.stack([lo.nuf_cores for lo in layouts]))
        kw = dict(budgets_w=np.full(2, 620.0), mode="per_vm", traces=traces)
        out[name] = mod.run_fleet_layouts(*args, backend="numpy", **kw)
        if mod is P:
            out["torch"] = P.run_fleet_layouts(*args, backend="torch",
                                               device="cpu", **kw)
    _equal(out["ref"], out["port"])
    _bars(out["ref"], out["torch"])


def test_budget_batch_matches_individual_runs():
    """A batched cap grid produces the per-budget runs."""
    specs = _specs(C, "server")
    caps = (250.0, 230.0, 210.0)
    batch = P.run_fleet(specs, list(caps), "per_vm", DUR, seed=3,
                        device="cpu")
    for i, cap in enumerate(caps):
        single = P.run_fleet(specs, cap, "per_vm", DUR, seed=3,
                             device="cpu")
        np.testing.assert_allclose(batch.power_w[i], single.power_w[0],
                                   atol=1e-3)
        assert batch.rapl_engaged_frac[i] == pytest.approx(
            single.rapl_engaged_frac[0], abs=1e-9)


def test_stack_layouts_mixed_core_padding():
    """Batching a padded-core chassis with a fully-active one keeps the
    real active masks; the engine runs the mix within the bars."""
    def pair(mod):
        a = mod.build_layout([mod.ServerSpec(
            vms=[mod.VMSpec(4, True), mod.VMSpec(8, False)], n_cores=16)],
            pad_uf_to=1, pad_nuf_to=1, pad_cores_to=24)
        b = mod.build_layout([mod.ServerSpec(
            vms=[mod.VMSpec(4, True), mod.VMSpec(8, False)], n_cores=24)],
            pad_uf_to=1, pad_nuf_to=1)
        return a, b
    a, b = pair(P)
    for layouts in ([a, b], [b, a]):
        la = P.stack_layouts(layouts)
        assert la.active is not None and la.active.shape == (2, 1, 24)
        assert {int(m.sum()) for m in la.active} == {16, 24}
    assert P.stack_layouts([b, b]).active is None
    out = {}
    for name, mod in (("ref", R), ("port", P)):
        layouts = list(pair(mod))
        traces = np.stack([mod.build_uf_traces(lo, 150, seed=i)
                           for i, lo in enumerate(layouts)])
        args = (mod.stack_layouts(layouts),
                np.stack([lo.uf_valid for lo in layouts]),
                np.stack([lo.nuf_valid for lo in layouts]),
                np.stack([lo.nuf_cores for lo in layouts]),
                np.array([150.0, 170.0]), "per_vm", traces)
        out[name] = mod.run_fleet_layouts(*args, backend="numpy")
        if mod is P:
            out["torch"] = P.run_fleet_layouts(*args, device="cpu")
    _equal(out["ref"], out["port"])
    _bars(out["ref"], out["torch"])


def test_core_padding_is_inert():
    """Padding the core axis changes no metric of the torch engine:
    padded cores are excluded from power sums, frequency means and the
    app models."""
    specs = _specs(C, "server")
    plain = P.build_layout(specs)
    padded = P.build_layout(specs, pad_cores_to=48)
    assert padded.active.sum() == plain.active.sum() == 40
    a = P.run_fleet(specs, 230.0, "per_vm", DUR, 3, layout=plain,
                    device="cpu")
    b = P.run_fleet(specs, 230.0, "per_vm", DUR, 3, layout=padded,
                    device="cpu")
    np.testing.assert_allclose(a.power_w, b.power_w, atol=1e-3)
    np.testing.assert_allclose(a.min_nuf_freq, b.min_nuf_freq, atol=0)
    assert a.uf_p95_latency[0] == pytest.approx(b.uf_p95_latency[0],
                                                rel=1e-6)


def test_sweep_and_frontier_match_reference():
    """`sweep_scenarios` + `frontier` on the torch engine give the
    reference oracle's frontier budgets, and the sweep's metrics meet
    the bars."""
    kw = dict(load_scales=(1.0, 0.8), fmin_nuf=(0.5, 0.75),
              duration_s=DUR, seed=3)
    caps = [260.0, 250.0, 240.0, 230.0, 220.0, 210.0]
    ref = R.sweep_scenarios(_specs(RC, "server"), caps, backend="numpy",
                            **kw)
    got = P.sweep_scenarios(_specs(C, "server"), caps, device="cpu", **kw)
    assert got["uf_p95_latency"].shape == (7, 2, 2)
    np.testing.assert_array_equal(got["budgets_w"], ref["budgets_w"])
    np.testing.assert_allclose(got["power_max_w"], ref["power_max_w"],
                               atol=POWER_TOL_W)
    assert np.abs(got["rapl_engaged_frac"]
                  - ref["rapl_engaged_frac"]).max() <= RAPL_FRAC_TOL
    for name in ("uf_p95_latency", "nuf_slowdown", "uf_latency_ratio"):
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-3,
                                   err_msg=name)
    for lim in ((1.05, 0.001), (1.10, 0.05)):
        fr, fg = R.frontier(ref, 310.0, *lim), P.frontier(got, 310.0, *lim)
        for k in fr:
            np.testing.assert_array_equal(fg[k], fr[k], err_msg=k)
    assert P.fmin_to_pstate(0.5) == 10 and P.fmin_to_pstate(1.0) == 0
    with pytest.raises(ValueError, match="uncapped"):
        P.frontier({"budgets_w": np.ones(1)}, 310.0)


def _random_state(rng, shape, n_cores):
    """A reachable-looking controller state: mixed p-states, some servers
    capping or in RAPL, frequencies at or under the intended ones."""
    pstate = rng.integers(0, 11, shape + (n_cores,)).astype(np.int32)
    freq = D.FREQ_TABLE[pstate] - np.where(
        rng.random(pstate.shape) < 0.3, np.float32(0.05), np.float32(0))
    return D.FleetState(
        np.maximum(freq, np.float32(0.5)).astype(np.float32), pstate,
        rng.random(shape) < 0.5, rng.random(shape) < 0.3,
        np.where(rng.random(shape) < 0.5, np.float32(29.9),
                 np.float32(np.inf)).astype(np.float32))


@pytest.mark.parametrize("mode", ["none", "rapl", "per_vm"])
def test_fleet_step_twin(mode):
    """One step from random states, batch dims (B,) on the run scalars:
    the numpy oracle array-equal to the reference's `xp=numpy` step, the
    torch twin equal in every discrete field and within float32 rounding
    in power."""
    rng = np.random.default_rng(5)
    B, S, Cn = 6, 3, 40
    cp = D.ControlParams(mode=mode)
    rcp = RD.ControlParams(mode=mode)
    uf = rng.random((S, Cn)) < 0.4
    budgets = rng.uniform(150, 260, B).astype(np.float32)
    rp = D.RunParams(budgets, budgets - 5.0, budgets * S * 0.97,
                     rng.integers(5, 11, B).astype(np.int32), uf, None)
    st = _random_state(rng, (B, S), Cn)
    util = rng.uniform(0.2, 1.0, (B, S, Cn)).astype(np.float32)
    want_st, want = RD.fleet_step(rcp, RD.RunParams(*rp),
                                  RD.FleetState(*st), util, np)
    got_st, got = D.fleet_step_np(cp, rp, st, util)
    for a, b in zip(tuple(got_st) + tuple(got), tuple(want_st) + tuple(want)):
        np.testing.assert_array_equal(a, b)

    def t(x):
        return torch.as_tensor(x)
    tst, tout = D.fleet_step(cp, D.RunParams(*(t(x) for x in rp[:5]), None),
                             D.FleetState(*(t(x) for x in st)), t(util))
    for a, b in zip((tst.pstate, tst.capping, tst.rapl, tout.alert,
                     tout.rapl),
                    (want_st.pstate, want_st.capping, want_st.rapl,
                     want.alert, want.rapl)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(tst.freq.numpy(), want_st.freq, atol=1e-6)
    np.testing.assert_allclose(tout.server_power_w.numpy(),
                               want.server_power_w, rtol=1e-5)
    np.testing.assert_array_equal(tst.clear_s.numpy(), want_st.clear_s)


def test_first_n_mask_twin_and_overflow():
    """The greedy selection picks the reference's cores, and a core axis
    too wide for the int16 keys raises in both copies."""
    rng = np.random.default_rng(2)
    elig = rng.random((4, 5, 40)) < 0.6
    level = rng.integers(0, 11, (4, 5, 40)).astype(np.int32)
    want = RD._first_n_mask(elig, level, 11, 4, np)
    np.testing.assert_array_equal(D._first_n_mask_np(elig, level, 11, 4),
                                  want)
    np.testing.assert_array_equal(
        D._first_n_mask(torch.as_tensor(elig), torch.as_tensor(level), 11,
                        4).numpy(), want)
    wide = np.ones((1, 2000), bool)
    for fn, x in ((D._first_n_mask_np, wide),
                  (D._first_n_mask, torch.as_tensor(wide))):
        with pytest.raises(ValueError, match="int16"):
            fn(x, x.astype(np.int32) if fn is D._first_n_mask_np
               else x.int(), 11, 4)
