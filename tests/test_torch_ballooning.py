"""The port's ballooning rung (`repro_torch.serve.ballooning`), the NUF
slice of the GB ledger, `PlaneBundle.ballooning` and `SimSpec.ballooning`
against the JAX package's, on the CPU.

- The numpy oracle (`*_np`) is array-equal to the reference's numpy call
  over randomized chassis (mixed loads, standing balloons, partial masks)
  in float32 and float64, and the torch twin is bit-equal to the oracle.
- The rung behaves as the reference's tests say: a fully served demand
  leaves the critical level at full frequency, the headroom caps the
  grab, a cleared alarm deflates, unmasked chassis pass through.
- `place_batch`/`remove_batch` keep `mem_nuf` equal to the reference's.
- A streamed pipeline with the rung decides as the reference pipeline
  does, at 1 and 4 ingest hosts.
- The sim with the rung gives the reference's trace and every
  `SimMetrics` field, on the event backend and on the serve backend
  (where the twin is checked on every scan).

The reference's own ballooning tests import `repro.serve`, which fails
collection on the installed jax, so its modules come through
`_torch_parity.reference_serve`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import reference_serve, service_dict, table_dict
from repro_torch import convert
from repro_torch.core.placement import ClusterState, SchedulerPolicy
from repro_torch.serve import ballooning as B
from repro_torch.serve import emergency as E
from repro_torch.serve import placement as P
from repro_torch.serve import (PlaneBundle, ServeConfig, ServePipeline)
from repro_torch.sim import scheduler_sim as S
from repro_torch.sim import telemetry as PT

BUDGET_TIGHT = 1480.0
C = 4


@pytest.fixture(scope="module")
def rb():
    return reference_serve("ballooning")


@pytest.fixture(scope="module")
def re():
    return reference_serve("emergency")


def _scenario(seed, dtype, n=C):
    """The reference test's randomized chassis loads: mixed NUF/UF
    commitments, standing balloons, hot and cool samples, partial
    masks."""
    rng = np.random.default_rng(seed)
    rho_lv = rng.uniform(10.0, 80.0, (n, 2)).astype(dtype)
    power = rng.uniform(900.0, 2600.0, n).astype(dtype)
    mem_nuf = rng.uniform(0.0, 600.0, n).astype(dtype)
    mask = rng.random(n) < 0.75
    standing = (rng.uniform(0.0, 40.0, n)
                * (rng.random(n) < 0.5)).astype(dtype)
    return rho_lv, power, mem_nuf, mask, standing


def _twin(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(6))
def test_oracle_matches_reference_and_twin_is_bit_equal(rb, re, seed, dtype):
    cfg = E.EmergencyConfig.from_model(BUDGET_TIGHT)
    rcfg = re.EmergencyConfig.from_model(BUDGET_TIGHT)
    rho_lv, power, mem_nuf, mask, standing = _scenario(seed, dtype, n=16)
    st, out = B.balloon_step_np(
        B.BallooningConfig(), cfg, B.BalloonState(standing.copy()), rho_lv,
        power, mem_nuf, mask)
    rst, rout = rb.balloon_step(
        rb.BallooningConfig(), rcfg, rb.BalloonState(standing.copy()),
        rho_lv, power, mem_nuf, mask, np)
    np.testing.assert_array_equal(st.ballooned_gb, rst.ballooned_gb)
    for name, a, b in zip(out._fields, out, rout):
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype, name
    tst, tout = B.balloon_step(
        B.BallooningConfig(), cfg, B.state_to_torch(
            B.BalloonState(standing.copy()), "cpu"), _twin(rho_lv),
        _twin(power), _twin(mem_nuf), _twin(mask))
    np.testing.assert_array_equal(tst.ballooned_gb.numpy(), st.ballooned_gb)
    for name, a, b in zip(out._fields, out, tout):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
        assert b.numpy().dtype == a.dtype, name
    alarm, demand = B.balloon_demand_w_np(cfg, rho_lv, power)
    ralarm, rdemand = rb.balloon_demand_w(rcfg, rho_lv, power)
    talarm, tdemand = B.balloon_demand_w(cfg, _twin(rho_lv), _twin(power))
    np.testing.assert_array_equal(alarm, ralarm)
    np.testing.assert_array_equal(demand, rdemand)
    np.testing.assert_array_equal(talarm.numpy(), alarm)
    np.testing.assert_array_equal(tdemand.numpy(), demand)


def _both(fn):
    """Run a behaviour check on the oracle and on the twin."""
    fn(B.balloon_step_np, E.masked_step_np, np.asarray,
       lambda st: st, B.init_ballooning_np(C), E.init_emergency_np(
           C, dtype=np.float64))
    fn(B.balloon_step, E.masked_step, _twin,
       lambda st: B.BalloonState(st.ballooned_gb.numpy()),
       B.init_ballooning(C, device="cpu"),
       E.init_emergency(C, dtype=torch.float64, device="cpu"))


def test_served_demand_zeroes_critical_throttle():
    """With unbounded headroom the closed form is exact: the adjusted
    sample leaves the critical level at full frequency and RAPL off,
    where the raw sample throttles it; NUF still takes its share."""
    cfg, bcfg = E.EmergencyConfig.from_model(BUDGET_TIGHT), \
        B.BallooningConfig()
    rho_lv = np.tile([60.0, 40.0], (C, 1))
    power = np.full(C, 2400.0)
    mask = np.ones(C, bool)
    alarm, demand = B.balloon_demand_w_np(cfg, rho_lv, power)
    assert alarm.all() and (demand > 0).all()

    def check(step, masked, arr, host, bst, est):
        raw, _ = masked(cfg, est, arr(rho_lv), arr(power), arr(mask),
                        arr(np.full(C, 1.0)))
        pst, rapl = np.asarray(raw.pstate), np.asarray(raw.rapl)
        assert (pst[:, E.CRIT_UF] > 0).all() or rapl.any()
        _, bout = step(bcfg, cfg, bst, arr(rho_lv), arr(power),
                       arr(np.full(C, 1e6)), arr(mask))
        assert np.asarray(bout.inflated).all()
        adj, _ = masked(cfg, est, arr(rho_lv), bout.power_adj_w, arr(mask),
                        arr(np.full(C, 1.0)))
        np.testing.assert_array_equal(np.asarray(adj.pstate)[:, E.CRIT_UF],
                                      0)
        assert not np.asarray(adj.rapl).any()
        assert (np.asarray(adj.pstate)[:, E.CRIT_NUF] > 0).all()
    _both(check)


def test_headroom_caps_grab_and_clear_deflates():
    cfg = E.EmergencyConfig.from_model(BUDGET_TIGHT)
    bcfg = B.BallooningConfig(reclaim_frac=0.5)
    rho_lv = np.tile([60.0, 40.0], (C, 1))
    mem_nuf = np.full(C, 10.0)            # tiny: the headroom binds
    ones = np.ones(C, bool)

    def check(step, masked, arr, host, bst, est):
        st, _ = step(bcfg, cfg, bst, arr(rho_lv), arr(np.full(C, 2400.0)),
                     arr(mem_nuf), arr(ones))
        np.testing.assert_allclose(host(st).ballooned_gb, 0.5 * mem_nuf)
        assert B.total_ballooned_gb(st) == pytest.approx(
            0.5 * mem_nuf.sum())
        st2, out2 = step(bcfg, cfg, st, arr(rho_lv), arr(np.full(C, 500.0)),
                         arr(mem_nuf), arr(ones))
        np.testing.assert_allclose(np.asarray(out2.released_gb),
                                   host(st).ballooned_gb)
        np.testing.assert_array_equal(host(st2).ballooned_gb, 0.0)
        assert not np.asarray(out2.inflated).any()
    _both(check)


def test_unmasked_chassis_pass_through():
    cfg = E.EmergencyConfig.from_model(BUDGET_TIGHT)
    rho_lv, power, mem_nuf, _, standing = _scenario(11, np.float64)
    mask = np.array([True, False, True, False])

    def check(step, masked, arr, host, bst, est):
        st = type(bst)(arr(standing.copy()))
        st2, out = step(B.BallooningConfig(), cfg, st, arr(rho_lv),
                        arr(power), arr(mem_nuf), arr(mask))
        np.testing.assert_array_equal(host(st2).ballooned_gb[~mask],
                                      standing[~mask])
        np.testing.assert_array_equal(np.asarray(out.power_adj_w)[~mask],
                                      power[~mask])
        np.testing.assert_array_equal(np.asarray(out.absorbed_w)[~mask],
                                      0.0)
    _both(check)


def test_place_and_remove_keep_mem_nuf_equal_to_reference():
    """`device_state(mem_nuf=)` seeds the NUF GB slice, `place_batch`
    credits each admitted NUF arrival's GB and `remove_batch` debits the
    departures (duplicate chassis, pinned rows, ignored rows) in the
    order-fixed sums: equal to the reference's in float32."""
    import jax.numpy as jnp
    from repro.core.placement import ClusterState as RCluster
    from repro.core.placement import SchedulerPolicy as RPolicy
    rserve = reference_serve()
    rng = np.random.default_rng(5)

    def loaded(cls):
        st = cls(n_servers=36, cores_per_server=40,
                 chassis_of_server=np.arange(36) // 12, n_chassis=3)
        r = np.random.default_rng(5)
        for _ in range(120):
            s, c = int(r.integers(0, 36)), int(r.integers(1, 8))
            if st.free_cores[s] >= c:
                st.place(s, c, float(r.uniform(0.05, 1)),
                         bool(r.random() < 0.5))
        return st
    mem_nuf0 = np.array([120.0, 40.0, 300.0])
    dst = P.device_state(loaded(ClusterState), torch.float32, "cpu",
                         mem_gb=mem_nuf0 * 2, mem_nuf=mem_nuf0)
    rdst = rserve.device_state(loaded(RCluster), jnp.float32,
                               mem_gb=mem_nuf0 * 2, mem_nuf=mem_nuf0)
    np.testing.assert_array_equal(dst.mem_nuf.numpy(),
                                  np.asarray(rdst.mem_nuf))
    b = 40
    cores = rng.choice([1.0, 2.0, 4.0], b).astype(np.float32)
    is_uf = rng.random(b) < 0.5
    p95 = rng.uniform(0.1, 1.0, b).astype(np.float32)
    mem = cores * 4.0
    valid = np.arange(b) < 36
    st, srv = P.place_batch(dst, cores, is_uf, p95, valid,
                            np.full(3, np.inf, np.float32),
                            SchedulerPolicy(alpha=0.8), 40, mem_gb=mem)
    rst, rsrv = rserve.place_batch(
        rdst, jnp.asarray(cores), jnp.asarray(is_uf), jnp.asarray(p95),
        jnp.asarray(valid), jnp.full(3, jnp.inf, jnp.float32),
        RPolicy(alpha=0.8), 40, mem_gb=jnp.asarray(mem))
    np.testing.assert_array_equal(srv.numpy(), np.asarray(rsrv))
    np.testing.assert_array_equal(st.mem_nuf.numpy(), np.asarray(rst.mem_nuf))
    assert (st.mem_nuf.numpy() > mem_nuf0).any()
    srvs = srv.numpy().astype(np.int32)
    dep = np.concatenate([srvs[:24], srvs[:6], [-1, -1]]).astype(np.int32)
    dcores = np.concatenate([cores[:24], -cores[:6], [1.0, 1.0]]) \
        .astype(np.float32)
    pick = np.r_[0:24, 0:6, 0:2]
    args = (dep, dcores, p95[pick], is_uf[pick])
    dmem = (np.abs(dcores) * 4.0 * np.sign(dcores)).astype(np.float32)
    got = P.remove_batch(st, *args, mem_gb=dmem)
    want = rserve.remove_batch(rst, *map(jnp.asarray, args),
                               mem_gb=jnp.asarray(dmem))
    np.testing.assert_array_equal(got.mem_nuf.numpy(),
                                  np.asarray(want.mem_nuf))
    np.testing.assert_array_equal(got.res_peak.numpy(),
                                  np.asarray(want.res_peak))


# --- the streamed pipeline with the rung ----------------------------------

N_STREAM, CHUNK = 256, 32          # 8 micro-batches of 32
STREAM_BUDGET_W = 1560.0


@pytest.fixture(scope="module")
def world():
    import jax.numpy as jnp
    from repro.core import features as RF
    from repro.core.criticality import classify as r_classify
    from repro.core.predictor import train_service
    from repro.sim.telemetry import generate_population
    rserve = reference_serve()
    pop = generate_population(600, seed=0)
    hist, _ = RF.split_history_arrivals(pop)
    labels = np.asarray(r_classify(jnp.asarray(hist.series)))
    aggs = RF.subscription_aggregates(hist, labels)
    svc = train_service(RF.build_features(hist, aggs),
                        labels.astype(np.int64),
                        RF.p95_bucket([v.p95_util for v in hist.vms]),
                        n_trees=12)
    cap = max(v.subscription for v in pop.vms) + 8
    return dict(hist=hist, labels=labels, svc=svc, cap=cap, rserve=rserve)


def _balloon_stream(pipe, tel, hosts, samples):
    """Arrival chunks dealt over `hosts`, every other admitted VM of chunk
    k-2 departing with its GB, and after every chunk a hot sweep of all
    three chassis (one sampled twice) between arrival ticks."""
    pop = tel.generate_population(N_STREAM, seed=9)
    stamps = tel.arrival_stamps(N_STREAM)
    cores = np.array([v.cores for v in pop.vms], np.float32)
    mem = np.array([v.memory_gb for v in pop.vms], np.float32)
    results = []
    for k in range(N_STREAM // CHUNK):
        idx = np.arange(k * CHUNK, (k + 1) * CHUNK)
        for h in range(hosts):
            rows = idx[idx % hosts == h]
            results += pipe.submit_to(h, tel.arrival_batch(pop, rows),
                                      t=stamps[rows])
        t_end = stamps[idx[-1]]
        if k >= 2:
            r = results[k - 2]
            adm = np.flatnonzero(r.server >= 0)[::2]
            rows = (k - 2) * CHUNK + adm
            results += pipe.depart_to(
                k % hosts, r.server[adm], cores[rows], r.p95_eff[adm],
                r.workload_type[adm] == 1, mem_gb=mem[rows],
                t=t_end + 0.25 + 1e-6 * np.arange(len(rows)))
        results += pipe.cap_to((k + 1) % hosts, [0, 1, 2, 1], samples[k],
                               t=t_end + 0.5 + (np.arange(4) + 1) * 1e-7)
    out = pipe.flush()
    return results + ([] if out is None else [out])


def test_pipeline_ballooning_requires_emergency(world):
    svc = convert.service_from_numpy(service_dict(world["svc"]))
    with pytest.raises(ValueError, match="requires PlaneBundle.emergency"):
        ServePipeline.from_history(
            svc, world["hist"], world["labels"], n_servers=36,
            cores_per_server=40, blades_per_chassis=12, device="cpu",
            config=ServeConfig(planes=PlaneBundle(
                ballooning=B.BallooningConfig())))


def test_pipeline_ballooning_matches_reference(world, re, rb):
    """Hot sweeps over a filling cluster (float32): the port's decisions,
    alarms and throttled-seconds equal the reference pipeline's
    (`kernel="ref"`) at 1 and 4 ingest hosts, the rung fires, and the
    memory ledger's NUF slice is the reference's. The reference compiles
    its balloon-then-cap step, and XLA contracts its multiply-adds, so
    the balloons are held to float32 rounding (rtol 1e-6); they are
    bit-equal across host counts."""
    rserve = world["rserve"]
    kw = dict(n_servers=36, cores_per_server=40, blades_per_chassis=12,
              table_capacity=world["cap"])
    samples = np.random.default_rng(21).uniform(
        1500.0, 2300.0, (N_STREAM // CHUNK, 4))
    ref = rserve.ServePipeline.from_history(
        world["svc"], world["hist"], world["labels"],
        config=rserve.ServeConfig(kernel="ref", batch_size=CHUNK,
                                  planes=rserve.PlaneBundle(
            emergency=re.EmergencyConfig.from_model(STREAM_BUDGET_W,
                                                    dwell_s=60.0),
            ballooning=rb.BallooningConfig())), **kw)
    from repro.sim import telemetry as RT
    want = _balloon_stream(ref, RT, 1, samples)
    assert ref.ballooned_gb() > 0
    pipes = {}
    for hosts in (1, 4):
        pipe = ServePipeline.from_history(
            convert.service_from_numpy(service_dict(world["svc"])),
            world["hist"], world["labels"], device="cpu",
            config=ServeConfig(batch_size=CHUNK, n_ingest_hosts=hosts,
                               planes=PlaneBundle(
                emergency=E.EmergencyConfig.from_model(STREAM_BUDGET_W,
                                                       dwell_s=60.0),
                ballooning=B.BallooningConfig())), **kw)
        pipe.table = convert.table_from_numpy(table_dict(ref.table), "cpu")
        got = _balloon_stream(pipe, PT, hosts, samples)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for f in ("server", "workload_type", "p95_bucket",
                      "conservative", "p95_eff"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                              err_msg=f)
        assert pipe.alarms == ref.alarms > 0
        np.testing.assert_array_equal(pipe.throttled_by_level(),
                                      ref.throttled_by_level())
        np.testing.assert_array_equal(pipe.state.mem_nuf.numpy(),
                                      np.asarray(ref.state.mem_nuf))
        np.testing.assert_allclose(
            pipe.balloon_state.ballooned_gb.numpy(),
            np.asarray(ref.balloon_state.ballooned_gb), rtol=1e-6)
        assert pipe.ballooned_gb() == pytest.approx(ref.ballooned_gb(),
                                                    rel=1e-6)
        pipes[hosts] = pipe
    assert torch.equal(pipes[1].balloon_state.ballooned_gb,
                       pipes[4].balloon_state.ballooned_gb)
    for a, b in zip(pipes[1].emergency, pipes[4].emergency):
        assert torch.equal(a, b)


# --- the sim with the rung ------------------------------------------------

LADDER_KW = dict(days=0.1, seed=0, deployments_per_hour=16.0,
                 prefill_core_ratio=0.6)


@pytest.mark.parametrize("backend", ["event", "serve"])
def test_sim_ladder_matches_reference(backend, re, rb):
    """cap -> balloon -> migrate at the reference test's size: the trace
    and every `SimMetrics` field equal the reference's event backend, its
    decision oracle (the port's serve backend also steps both twins on
    every scan, bit-equal to the numpy oracle). On the event backend,
    against cap -> migrate, the rung keeps the alarms and the decisions
    and cuts the critical throttled-seconds."""
    from repro.core.placement import SchedulerPolicy as RPolicy
    from repro.sim import scheduler_sim as RS
    pol = SchedulerPolicy(alpha=0.8)
    got, tr = {}, {}
    for rung in (False, True) if backend == "event" else (True,):
        tr_p, tr_r = [], []
        got[rung] = S.simulate(pol, S.PredictionChannel("ml"), S.SimSpec(
            emergency=E.EmergencyConfig.from_model(BUDGET_TIGHT,
                                                   dwell_s=120.0),
            ballooning=B.BallooningConfig() if rung else None,
            serve=S.ServeBackendSpec(backend=backend), **LADDER_KW),
            trace=tr_p, device="cpu")
        want = RS.simulate(RPolicy(alpha=0.8), RS.PredictionChannel("ml"),
                           RS.SimSpec(
            emergency=re.EmergencyConfig.from_model(BUDGET_TIGHT,
                                                    dwell_s=120.0),
            ballooning=rb.BallooningConfig() if rung else None,
            serve=RS.ServeBackendSpec(backend="event"), **LADDER_KW),
            trace=tr_r)
        assert tr_p == tr_r
        for f in dataclasses.fields(want):
            a, b = getattr(got[rung], f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
        tr[rung] = tr_p
    assert got[True].balloon_events > 0
    if backend != "event":
        return
    base, rung = got[False], got[True]
    assert base.alarms == rung.alarms > 0
    assert rung.balloon_events > 0 and rung.balloon_reclaimed_gb > 0
    assert rung.uf_throttled_s < base.uf_throttled_s
    assert rung.migrations <= base.migrations
    assert base.balloon_events == 0
    assert tr[False] == tr[True]


def test_sim_ballooning_requires_emergency():
    with pytest.raises(ValueError, match="ballooning requires"):
        S.SimSpec(ballooning=B.BallooningConfig())
