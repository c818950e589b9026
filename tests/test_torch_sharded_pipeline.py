"""The port's sharded serving pipeline (`ShardedServePipeline`) and the
scheduler simulation's `serve-sharded` backend against the JAX package's,
on the CPU.

- One shard decides as the unsharded `ServePipeline`, and its global state
  is the unsharded state.
- Four shards under a `cluster_budget` decide as the reference's sharded
  pipeline: servers, pools and spill counters; a warm start nets its
  committed rho out of the pool; misconfigurations raise, the reference's
  refusals of the mesh knobs among them; `state` and `res_cap` read the
  shards. The `spill_rounds` and `rebalance_tokens` knobs give the
  reference pipeline's decisions, pools and spill counters, on the batch
  axis and on a CPU mesh (`mesh=shard_mesh(4, devices=("cpu",) * 4)`,
  the table row-partitioned over it). Retargeting the pools after a shard has
  committed past its slice of the budget over-grants the others, in the
  reference as in the port (a known defect, kept for parity).
- The streamed loop (`submit_to`/`depart_to`/`cap_to`) with the emergency,
  ballooning and adaptive planes at 4 shards, at 1 and 4 ingest hosts,
  decides as the reference's, with its alarms and per-shard ratios. At one
  shard the reference's sharded and unsharded pipelines agree on that
  stream, and so do the port's.
- `simulate(backend="serve-sharded")`: one shard gives the `serve` and
  `event` traces; four shards, with and without a cluster budget (and
  with the adaptive plane), give the reference's trace and every
  `SimMetrics` field; 4 ingest hosts give the 1-host trace.

The reference's `tests/test_serve_sharded.py` fails collection on the
installed jax; its objects come through `_torch_parity`.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_parity import (reference_enable_x64, reference_serve,  # noqa
                           service_dict, table_dict)
from repro.core.placement import ClusterState  # noqa: E402
from repro.core.placement import SchedulerPolicy as RPolicy  # noqa: E402
from repro.core.resources import ResourceVector as RVector  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.placement import SchedulerPolicy  # noqa: E402
from repro_torch.serve import (FAIL_TOKENS, PlaneBundle,  # noqa: E402
                               ResourceVector, ServeConfig, ServePipeline,
                               ShardedServeConfig, ShardedServePipeline,
                               ShardedTable, device_state,
                               rho_pool_from_budget, shard_mesh, shard_table,
                               table_from_history)
from repro_torch.serve import adaptive as A  # noqa: E402
from repro_torch.serve import ballooning as B  # noqa: E402
from repro_torch.serve import emergency as E  # noqa: E402
from repro_torch.sim import scheduler_sim as S  # noqa: E402
from repro_torch.sim import telemetry as PT  # noqa: E402

KW = dict(n_servers=48, cores_per_server=40, blades_per_chassis=12)
CLUSTER_W = 48 * 112.0 + 800.0       # the reference test's cluster budget
N_STREAM, CHUNK = 256, 32
STREAM_BUDGET_W = 1560.0
ADAPTIVE_KW = dict(window=4, min_history=2, hot_util=0.7, step_up=0.15,
                   step_down=0.5, ratio_max=3.0)


@pytest.fixture(scope="module")
def rserve():
    return reference_serve()


@pytest.fixture(scope="module")
def world(rserve):
    from repro.core import features as RF
    from repro.core.predictor import train_service
    from repro.sim.telemetry import generate_population
    pop = generate_population(500, seed=0)
    hist, arrivals = RF.split_history_arrivals(pop)
    labels = hist.labels.astype(np.float64)
    aggs = RF.subscription_aggregates(hist, labels)
    svc = train_service(RF.build_features(hist, aggs),
                        labels.astype(np.int64),
                        RF.p95_bucket([v.p95_util for v in hist.vms]),
                        n_trees=12)
    return dict(svc=svc, hist=hist, labels=labels, arrivals=arrivals,
                cap=max(v.subscription for v in pop.vms) + 64)


def _port(world, cls=ShardedServePipeline, config=None, table=None,
          mesh=None):
    """A port pipeline on the CPU, on `mesh` when given; `table`, a
    reference table, replaces its own (row-partitioned over the mesh as
    its own was)."""
    pipe = cls.from_history(
        convert.service_from_numpy(service_dict(world["svc"])),
        world["hist"], world["labels"], table_capacity=world["cap"],
        config=config, device="cpu", **KW,
        **({} if mesh is None else {"mesh": mesh}))
    if table is not None:
        pipe.table = convert.table_from_numpy(table_dict(table), "cpu")
        if isinstance(getattr(pipe, "mesh", None), tuple) \
                and pipe.config.shard_table:
            pipe.table = shard_table(pipe.table, pipe.mesh)
    return pipe


def _ref(world, rserve, cls, config):
    return getattr(rserve, cls).from_history(
        world["svc"], world["hist"], world["labels"],
        table_capacity=world["cap"], config=config, **KW)


def _assert_results_equal(got, want):
    for f in ("server", "workload_type", "p95_bucket", "conservative",
              "p95_eff"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


# --- the pipeline ---------------------------------------------------------

def test_one_shard_pipeline_is_unsharded(world):
    base = _port(world, ServePipeline, ServeConfig(batch_size=32))
    shp = _port(world, config=ShardedServeConfig(batch_size=32, n_shards=1))
    b = PT.arrival_batch(world["arrivals"], np.arange(96))
    _assert_results_equal(shp.serve(b), base.serve(b))
    got = shp.global_state()
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(base.state, f)), f
    assert shp.spill_info == {"rounds": 3, "spilled": 0, "spill_admitted": 0}
    assert np.isinf(shp.pool_left_vec()).all()


def test_four_shards_under_a_cluster_budget_match_reference(world, rserve):
    ref = _ref(world, rserve, "ShardedServePipeline",
               rserve.ShardedServeConfig(
                   kernel="ref", batch_size=32, n_shards=4,
                   planes=rserve.PlaneBundle(
                       cluster_budget=RVector(watts=CLUSTER_W))))
    pipe = _port(world, config=ShardedServeConfig(
        batch_size=32, n_shards=4, planes=PlaneBundle(
            cluster_budget=ResourceVector(watts=CLUSTER_W))),
        table=ref.table)
    from repro.sim.telemetry import arrival_batch
    b = arrival_batch(world["arrivals"], np.arange(160))
    got, want = pipe.serve(b), ref.serve(b)
    _assert_results_equal(got, want)
    np.testing.assert_array_equal(pipe.pool_left_vec(), ref.pool_left_vec())
    assert pipe.spill_info == ref.spill_info
    assert pipe.spill_info["spilled"] > 0
    assert got.n_token_rejected == want.n_token_rejected > 0
    assert got.n_admitted + got.n_capacity_rejected + got.n_power_rejected \
        + got.n_token_rejected == 160
    # the pool spent is what was admitted, across the shards
    pool0 = rho_pool_from_budget(CLUSTER_W, 48)
    rho = float(pipe.global_state().rho_peak.double().sum())
    assert rho <= pool0 + 1e-4
    np.testing.assert_allclose(pipe.pool_left().sum(), pool0 - rho,
                               atol=1e-4)
    for f, a, b in zip(pipe.global_state()._fields, pipe.global_state(),
                       ref.global_state()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


def test_warm_start_nets_committed_rho(world, rserve):
    st = ClusterState(n_servers=48, cores_per_server=40,
                      chassis_of_server=np.arange(48) // 12, n_chassis=4)
    st.place(0, 20, 0.9, True)            # 18 rho units committed
    cfg = ShardedServeConfig(batch_size=32, n_shards=4, planes=PlaneBundle(
        cluster_budget=ResourceVector(watts=CLUSTER_W)))
    table = table_from_history(world["hist"], world["labels"], world["cap"],
                               "cpu")
    pipe = ShardedServePipeline(
        convert.service_from_numpy(service_dict(world["svc"])), table,
        device_state(st, device="cpu"), 40, config=cfg,
        blades_per_chassis=12)
    ref = rserve.ShardedServePipeline(
        world["svc"], rserve.table_from_history(world["hist"],
                                                world["labels"],
                                                world["cap"]),
        rserve.device_state(st), cores_per_server=40, blades_per_chassis=12,
        config=rserve.ShardedServeConfig(
            batch_size=32, n_shards=4, planes=rserve.PlaneBundle(
                cluster_budget=RVector(watts=CLUSTER_W))))
    np.testing.assert_array_equal(pipe.pool_left_vec(), ref.pool_left_vec())
    np.testing.assert_allclose(pipe.pool_left().sum(),
                               rho_pool_from_budget(CLUSTER_W, 48) - 18.0,
                               rtol=1e-5)


def test_sharded_config_refuses_misuse(world):
    with pytest.raises(ValueError, match="not divisible"):
        _port(world, config=ShardedServeConfig(batch_size=30, n_shards=4))
    with pytest.raises(ValueError, match="divide"):
        _port(world, config=ShardedServeConfig(batch_size=30, n_shards=3))
    # the reference's refusals of the mesh knobs: use_shard_map=True wants
    # a card a shard (this machine has fewer than 4), and a mesh one
    # device a shard
    with pytest.raises(RuntimeError, match="use_shard_map=True needs"):
        _port(world, config=ShardedServeConfig(batch_size=32, n_shards=4,
                                               use_shard_map=True))
    with pytest.raises(ValueError, match="takes 4 devices, got 2"):
        _port(world, config=ShardedServeConfig(batch_size=32, n_shards=4),
              mesh=("cpu",) * 2)
    with pytest.raises(ValueError, match="use_shard_map"):
        ShardedServeConfig(n_shards=2, use_shard_map="always")
    with pytest.raises(ValueError, match="spill_rounds"):
        ShardedServeConfig(n_shards=2, spill_rounds=-1)
    # the default and "auto" run the batch axis on the CPU; an explicit
    # mesh is taken
    for knob in ({}, {"use_shard_map": "auto"}):
        pipe = _port(world, config=ShardedServeConfig(batch_size=32,
                                                      n_shards=4, **knob))
        assert pipe.mesh is None and not isinstance(pipe.table, ShardedTable)
    pipe = _port(world, config=ShardedServeConfig(batch_size=32, n_shards=4),
                 mesh=("cpu",) * 4)
    assert pipe.mesh == shard_mesh(4, devices=("cpu",) * 4)
    assert isinstance(pipe.table, ShardedTable)


@pytest.mark.parametrize("on_mesh,table_on_mesh",
                         [(False, False), (True, True), (True, False)],
                         ids=["batch", "mesh4", "mesh4_whole_table"])
@pytest.mark.parametrize("spill_rounds,rebalance", [(0, True), (1, False)],
                         ids=["home_only", "one_spill_no_rebalance"])
def test_pipeline_knobs_match_reference(world, rserve, spill_rounds,
                                        rebalance, on_mesh, table_on_mesh):
    """`spill_rounds` and `rebalance_tokens` on the pipeline at 4 shards
    under the cluster budget: the reference pipeline's decisions, pools
    left and spill counters, on either leg; on the mesh the state lies on
    the mesh, and the table too unless `shard_table=False` keeps it whole
    on the pipeline's device."""
    knobs = dict(spill_rounds=spill_rounds, rebalance_tokens=rebalance,
                 shard_table=table_on_mesh)
    ref = _ref(world, rserve, "ShardedServePipeline",
               rserve.ShardedServeConfig(
                   kernel="ref", batch_size=32, n_shards=4, **knobs,
                   planes=rserve.PlaneBundle(
                       cluster_budget=RVector(watts=CLUSTER_W))))
    pipe = _port(world, config=ShardedServeConfig(
        batch_size=32, n_shards=4, **knobs, planes=PlaneBundle(
            cluster_budget=ResourceVector(watts=CLUSTER_W))),
        table=ref.table, mesh=("cpu",) * 4 if on_mesh else None)
    assert (pipe.mesh is not None) == on_mesh
    assert isinstance(pipe.table, ShardedTable) == table_on_mesh
    from repro.sim.telemetry import arrival_batch
    b = arrival_batch(world["arrivals"], np.arange(160))
    got, want = pipe.serve(b), ref.serve(b)
    _assert_results_equal(got, want)
    np.testing.assert_array_equal(pipe.pool_left_vec(), ref.pool_left_vec())
    assert pipe.spill_info == ref.spill_info
    assert (pipe.spill_info["spilled"] > 0) == (spill_rounds > 0)
    for f, a, b in zip(pipe.global_state()._fields, pipe.global_state(),
                       ref.global_state()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


def test_state_and_caps_read_the_shards(world):
    """`state` is the global view of the shards and `res_cap`/`rho_cap`
    the per-shard ceilings in force, in global chassis order; neither can
    be assigned."""
    pipe = _port(world, config=ShardedServeConfig(
        batch_size=32, n_shards=4, planes=PlaneBundle(
            chassis_budget=ResourceVector(watts=STREAM_BUDGET_W))))
    pipe.serve(PT.arrival_batch(world["arrivals"], np.arange(64)))
    for f, a, b in zip(pipe.state._fields, pipe.state, pipe.global_state()):
        assert torch.equal(a, b), f
    base = pipe.rho_cap.clone()
    assert base.shape == (4,) and torch.isfinite(base).all()
    pipe.set_resource_ratios([1.0, 0.5, 0.5])
    assert torch.equal(pipe.rho_cap, base)
    assert torch.equal(pipe.res_cap, pipe.sharded.res_cap.reshape(4, 3))
    with pytest.raises(AttributeError, match="sharded"):
        pipe.state = pipe.global_state()
    with pytest.raises(AttributeError, match="sharded"):
        pipe.res_cap = pipe.res_cap


def test_retargeted_pools_overgrant_past_a_full_shard(world, rserve):
    """A known defect of the reference, kept for parity (ROADMAP.md Queue
    3): retargeting the pools floors each shard at 0 on its own. With
    shard 0 warm past its half of the budget, a retarget hands shard 1 its
    whole half, so the free pools exceed what the budget has left by
    shard 0's overdraft. Port and reference give the same pools."""
    pool0 = rho_pool_from_budget(CLUSTER_W, 48)
    st = ClusterState(n_servers=48, cores_per_server=40,
                      chassis_of_server=np.arange(48) // 12, n_chassis=4)
    srv = 0
    while st.rho_peak.sum() < 0.7 * pool0:      # all on shard 0's chassis
        st.place(srv, 40, 0.9, True)
        srv += 1
    c0 = float(st.rho_peak.sum())
    assert pool0 / 2 < c0 < pool0 and srv <= 24
    cfg = ShardedServeConfig(batch_size=32, n_shards=2, planes=PlaneBundle(
        cluster_budget=ResourceVector(watts=CLUSTER_W)))
    pipe = ShardedServePipeline(
        convert.service_from_numpy(service_dict(world["svc"])),
        table_from_history(world["hist"], world["labels"], world["cap"],
                           "cpu"),
        device_state(st, device="cpu"), 40, config=cfg,
        blades_per_chassis=12)
    ref = rserve.ShardedServePipeline(
        world["svc"], rserve.table_from_history(world["hist"],
                                                world["labels"],
                                                world["cap"]),
        rserve.device_state(st), cores_per_server=40, blades_per_chassis=12,
        config=rserve.ShardedServeConfig(
            batch_size=32, n_shards=2, planes=rserve.PlaneBundle(
                cluster_budget=RVector(watts=CLUSTER_W))))
    np.testing.assert_allclose(pipe.pool_left().sum(), pool0 - c0,
                               rtol=1e-5)
    for p in (pipe, ref):
        p.set_resource_ratios([1.0, 1.0, 1.0])
    np.testing.assert_array_equal(pipe.pool_left_vec(), ref.pool_left_vec())
    left = pipe.pool_left()
    assert left[0] == 0.0
    np.testing.assert_allclose(left.sum(), pool0 / 2, rtol=1e-5)
    np.testing.assert_allclose(left.sum() - (pool0 - c0), c0 - pool0 / 2,
                               rtol=1e-4)


# --- the streamed loop with every plane -----------------------------------

def _rho_levels(pipe):
    """(4, L) committed rho per chassis and level of either pipeline,
    float64 on the host."""
    st = pipe.global_state() if hasattr(pipe, "global_state") else pipe.state
    g = [np.asarray(a.numpy() if torch.is_tensor(a) else a, np.float64)
         for a in (st.gamma_nuf, st.gamma_uf)]
    return np.stack([x.reshape(4, 12).sum(-1) for x in g], -1)


def _stream(pipe, tel, hosts, utils, samples=None):
    """Arrival chunks dealt over `hosts`, every other admitted VM of chunk
    k-2 departing with its GB, and after every chunk a sweep of all four
    chassis (one sampled twice) between arrival ticks: the power the
    live aggregates offer at the chunk's utilization, or a hot sweep
    past the NUF floor where the utilization is None (taken from
    `samples` when given, so every pipeline sees the first run's
    powers). Returns results, alarms, the ratios and the GB ballooned
    out after each chunk, and the samples."""
    pop = tel.generate_population(N_STREAM, seed=9)
    stamps = tel.arrival_stamps(N_STREAM)
    cores = np.array([v.cores for v in pop.vms], np.float32)
    mem = np.array([v.memory_gb for v in pop.vms], np.float32)
    results, ratios, swept, balloons = [], [], [], []
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
        out = pipe.flush()
        results += [] if out is None else [out]
        if samples is None and utils[k] is None:     # a hot sweep
            power = np.array([2300.0, 2150.0, 2250.0, 2200.0, 2100.0])
        elif samples is None:
            power = A.offered_power(A.AdaptiveConfig(), _rho_levels(pipe),
                                    utils[k])
            power = np.append(power, power[1] * 0.95)
        else:
            power = samples[k]
        swept.append(power)
        results += pipe.cap_to((k + 1) % hosts, [0, 1, 2, 3, 1], power,
                               t=t_end + 0.5 + (np.arange(5) + 1) * 1e-7)
        out = pipe.flush()
        results += [] if out is None else [out]
        ratios.append(np.ravel(pipe.adaptive_ratio).astype(np.float64))
        balloons.append(pipe.ballooned_gb())
    return (results, pipe.alarms, np.stack(ratios), swept,
            np.array(balloons))


UTILS = (0.3, 0.3, 0.3, 0.35, None, None, 0.3, 0.3)


def test_streamed_planes_at_four_shards_match_reference(world, rserve):
    """Four shards, every plane and a cluster budget (float32): the port's
    decisions, alarms, throttled-seconds and per-shard ratios equal the
    reference's at 1 and 4 ingest hosts, the rung fires, a ratio moves.
    The pools the controller retargets sum each shard's committed ledger,
    which XLA adds in its own order, so they are held to float32 rounding
    (rtol 1e-6); they are bit-equal across host counts."""
    rb, ra = reference_serve("ballooning"), reference_serve("adaptive")
    re = reference_serve("emergency")
    from repro.sim import telemetry as RT
    budget = 48 * 112.0 + 2000.0
    ref = _ref(world, rserve, "ShardedServePipeline",
               rserve.ShardedServeConfig(
                   kernel="ref", batch_size=CHUNK, n_shards=4,
                   planes=rserve.PlaneBundle(
                       emergency=re.EmergencyConfig.from_model(
                           STREAM_BUDGET_W, dwell_s=60.0),
                       ballooning=rb.BallooningConfig(),
                       adaptive=ra.AdaptiveConfig(**ADAPTIVE_KW),
                       cluster_budget=RVector(watts=budget))))
    want, want_alarms, want_r, samples, want_gb = _stream(ref, RT, 1, UTILS)
    assert want_alarms > 0 and want_gb.max() > 0
    assert (want_r != 1.0).any()
    pipes = {}
    for hosts in (1, 4):
        pipe = _port(world, config=ShardedServeConfig(
            batch_size=CHUNK, n_shards=4, n_ingest_hosts=hosts,
            planes=PlaneBundle(
                emergency=E.EmergencyConfig.from_model(STREAM_BUDGET_W,
                                                       dwell_s=60.0),
                ballooning=B.BallooningConfig(),
                adaptive=A.AdaptiveConfig(**ADAPTIVE_KW),
                cluster_budget=ResourceVector(watts=budget))),
            table=ref.table)
        got, alarms, ratios, _, gb = _stream(pipe, PT, hosts, UTILS,
                                             samples)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_results_equal(g, w)
        assert alarms == want_alarms
        np.testing.assert_array_equal(ratios, want_r)
        np.testing.assert_allclose(gb, want_gb, rtol=1e-6)
        np.testing.assert_array_equal(pipe.throttled_by_level(),
                                      ref.throttled_by_level())
        np.testing.assert_allclose(pipe.pool_left_vec(),
                                   ref.pool_left_vec(), rtol=1e-6)
        assert pipe.spill_info == ref.spill_info
        pipes[hosts] = pipe
    one, four = pipes[1], pipes[4]
    assert torch.equal(one.sharded.pool, four.sharded.pool)
    for a, b in zip(one.global_state(), four.global_state()):
        assert torch.equal(a, b)
    for x, y in ((one.emergency, four.emergency),
                 (one.balloon_state, four.balloon_state),
                 (one.adaptive_state, four.adaptive_state)):
        for a, b in zip(x, y):
            assert torch.equal(a, b)


def test_streamed_planes_at_one_shard_are_unsharded(world, rserve):
    """At one shard the reference's sharded pipeline decides on the
    streamed cell with every plane as its unsharded pipeline does (no
    cluster budget, which only the sharded pipeline reads), and the
    port's two pipelines do too, with equal plane states."""
    rb, ra = reference_serve("ballooning"), reference_serve("adaptive")
    re = reference_serve("emergency")
    from repro.sim import telemetry as RT
    rplanes = dict(emergency=re.EmergencyConfig.from_model(STREAM_BUDGET_W,
                                                           dwell_s=60.0),
                   ballooning=rb.BallooningConfig(),
                   adaptive=ra.AdaptiveConfig(**ADAPTIVE_KW))
    runs = {}
    for name, cls, cfg in (
            ("ref", "ServePipeline", rserve.ServeConfig),
            ("ref_sharded", "ShardedServePipeline",
             rserve.ShardedServeConfig)):
        extra = {} if cfg is rserve.ServeConfig else {"n_shards": 1}
        pipe = _ref(world, rserve, cls, cfg(
            kernel="ref", batch_size=CHUNK,
            planes=rserve.PlaneBundle(**rplanes), **extra))
        runs[name] = (pipe, _stream(pipe, RT, 1, UTILS,
                                    runs["ref"][1][3] if runs else None))
    pplanes = dict(emergency=E.EmergencyConfig.from_model(STREAM_BUDGET_W,
                                                          dwell_s=60.0),
                   ballooning=B.BallooningConfig(),
                   adaptive=A.AdaptiveConfig(**ADAPTIVE_KW))
    table = runs["ref"][0].table
    for name, cls, cfg in (
            ("port", ServePipeline, ServeConfig),
            ("port_sharded", ShardedServePipeline, ShardedServeConfig)):
        extra = {} if cfg is ServeConfig else {"n_shards": 1}
        pipe = _port(world, cls, cfg(batch_size=CHUNK,
                                     planes=PlaneBundle(**pplanes), **extra),
                     table=table)
        runs[name] = (pipe, _stream(pipe, PT, 1, UTILS, runs["ref"][1][3]))
    want, want_alarms, want_r, _, want_gb = runs["ref"][1]
    assert want_alarms > 0 and (want_r != 1.0).any() and want_gb.max() > 0
    for name in ("ref_sharded", "port", "port_sharded"):
        got, alarms, ratios, _, _ = runs[name][1]
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            _assert_results_equal(g, w)
        assert alarms == want_alarms, name
        np.testing.assert_array_equal(ratios, want_r, err_msg=name)
    port, port_sh = runs["port"][0], runs["port_sharded"][0]
    for x, y in ((port.emergency, port_sh.emergency),
                 (port.balloon_state, port_sh.balloon_state),
                 (port.adaptive_state, port_sh.adaptive_state)):
        for a, b in zip(x, y):
            assert torch.equal(a.reshape(b.shape), b)
    for a, b in zip(port.state, port_sh.global_state()):
        assert torch.equal(a, b)


# --- the simulation's serve-sharded backend -------------------------------

SIM_DAYS = 0.25
TOKEN_W = 720 * 112.0 + 4.95 * 400.0    # the reference test's 400-rho pool


@pytest.fixture
def ref_serve(monkeypatch):
    reference_serve()
    reference_enable_x64(monkeypatch)


def _assert_metrics_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _sim(mod, trace, device="cpu", **serve):
    pol = (SchedulerPolicy if mod is S else RPolicy)(alpha=0.8)
    kw = {"device": device} if mod is S else {}
    adaptive = serve.pop("adaptive", None)
    spec = mod.SimSpec(days=SIM_DAYS, seed=0, adaptive=adaptive,
                       serve=mod.ServeBackendSpec(**serve))
    return mod.simulate(pol, mod.PredictionChannel("ml"), spec, trace=trace,
                        **kw)


def test_sim_one_shard_is_serve_and_event():
    tr = {k: [] for k in ("event", "serve", "sharded")}
    e = _sim(S, tr["event"])
    _sim(S, tr["serve"], backend="serve")
    sh = _sim(S, tr["sharded"], backend="serve-sharded", shards=1)
    assert tr["event"] == tr["serve"] == tr["sharded"]
    assert (e.failure_rate, e.empty_server_ratio) == \
        (sh.failure_rate, sh.empty_server_ratio)


@pytest.mark.parametrize("case", ["free", "budget", "budget_adaptive"])
def test_sim_four_shards_match_reference(ref_serve, case):
    """Four shards, unbudgeted, under the reference test's 400-rho cluster
    budget (token rejections, conservation asserted on every group), and
    with the adaptive controller retargeting that budget: the reference's
    trace and every `SimMetrics` field."""
    from repro.sim import scheduler_sim as RS
    from repro.serve.adaptive import AdaptiveConfig as RAdaptive
    serve = dict(backend="serve-sharded", shards=4)
    pserve, rserve_kw = dict(serve), dict(serve)
    if case != "free":
        pserve["cluster_budget"] = ResourceVector(watts=TOKEN_W)
        rserve_kw["cluster_budget"] = RVector(watts=TOKEN_W)
    if case == "budget_adaptive":
        pserve["adaptive"] = A.AdaptiveConfig(**ADAPTIVE_KW)
        rserve_kw["adaptive"] = RAdaptive(**ADAPTIVE_KW)
    tr_p, tr_r = [], []
    got = _sim(S, tr_p, **pserve)
    want = _sim(RS, tr_r, **rserve_kw)
    assert tr_p == tr_r
    _assert_metrics_equal(got, want)
    if case == "budget":
        assert got.failure_rate > 0 and FAIL_TOKENS in tr_p
    if case == "budget_adaptive":
        assert got.adaptive_ratchets > 0


def test_sim_ingest_hosts_give_the_one_host_trace():
    tr1, tr4 = [], []
    budget = ResourceVector(watts=TOKEN_W)
    m1 = _sim(S, tr1, backend="serve-sharded", shards=4,
              cluster_budget=budget)
    m4 = _sim(S, tr4, backend="serve-sharded", shards=4, ingest_hosts=4,
              cluster_budget=budget)
    assert tr1 == tr4
    _assert_metrics_equal(m4, m1)
    with pytest.raises(ValueError, match="ingest_hosts"):
        _sim(S, [], backend="serve", ingest_hosts=2)
    with pytest.raises(ValueError, match="ingest_hosts"):
        _sim(S, [], ingest_hosts=4)
