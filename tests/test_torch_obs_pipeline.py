"""The observability plane on the port's pipelines, on the CPU.

- Obs on decides as obs off, bit for bit, unsharded and at 1 and 4 shards,
  with the emergency, ballooning and adaptive planes, at 1 and 4 ingest
  hosts; at 4 shards on a CPU mesh (one shard a position, the table
  row-partitioned over it) the obs-on pipeline is held the same way to
  the batch-axis pipeline with obs off, its pools too; and the port's
  registry snapshot equals the reference
  pipeline's on the same stream in every counter and gauge, but for the
  span timings (held by name and count) and the float sums of the
  emergency and ballooning sweeps and of what derives from them (held to
  1e-6 relative, the bar ROADMAP.md Queue 3 states for `cut_w` and
  `leftover_w`). The calibration error (`quality_ece`) is held to the
  same bar: it averages the raw heads' float32 confidences, forest sums
  that the port adds in another order than XLA (1-2 ulp apart; the heads
  and every gated decision are equal).
- `verify_replay` on a fresh pipeline reproduces the recorded decisions;
  the scorecard reconciles with `core.forest.evaluate`; `hot_swap` resets
  it; `hold_on_stale` clamps the applied ratio only while the model is
  stale; tokens drawn minus tokens credited is the pools' change.

The reference's pipelines come through `_torch_parity.reference_serve`.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_parity import (reference_serve, service_dict,  # noqa: E402
                           table_dict)
from repro import obs as R  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as P  # noqa: E402
from repro_torch.core import forest as PF  # noqa: E402
from repro_torch.obs.quality import PredictionScorecard  # noqa: E402
from repro_torch.obs.recorder import verify_replay  # noqa: E402
from repro_torch.serve import (PlaneBundle, ResourceVector,  # noqa: E402
                               ServeConfig, ServePipeline,
                               ShardedServeConfig, ShardedServePipeline,
                               featurize_batch, shard_table)
from repro_torch.serve import adaptive as A  # noqa: E402
from repro_torch.serve import ballooning as B  # noqa: E402
from repro_torch.serve import emergency as E  # noqa: E402
from repro_torch.sim import telemetry as PT  # noqa: E402

KW = dict(n_servers=48, cores_per_server=40, blades_per_chassis=12)
N_STREAM, CHUNK = 192, 32
STREAM_BUDGET_W = 1560.0
CLUSTER_W = 48 * 112.0 + 2000.0
ADAPTIVE_KW = dict(window=4, min_history=2, hot_util=0.7, step_up=0.15,
                   step_down=0.5, ratio_max=3.0)
#: the utilization of each chunk's sweep; None is a hot sweep past the
#: NUF floor (alarms, the rung fires, the controllers back off)
UTILS = (0.3, 0.3, 0.3, None, 0.3, 0.3)
HOT = np.array([2300.0, 2150.0, 2250.0, 2200.0, 2100.0])
#: registry families whose values are float sums of the emergency and
#: ballooning sweeps, the pools they retarget, or derive from them
FLOAT_FAMILIES = {
    "emergency_cut_watts_total", "emergency_leftover_watts_total",
    "emergency_level_cut_watts_total", "emergency_cut_watts",
    "balloon_reclaimed_gb_total", "balloon_released_gb_total",
    "balloon_absorbed_watts_total", "balloon_ballooned_gb",
    "serve_pool_tokens", "serve_pool_resources", "serve_tokens_drawn_total",
    "serve_tokens_drawn_res_total", "obs_window_sum",
    "obs_window_rate_per_s", "slo_burn_rate", "quality_ece"}
#: host-clock timings: held by name and count only
TIME_FAMILIES = {"serve_span_seconds"}


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
    cap = max(v.subscription for v in pop.vms) + 64
    table = rserve.table_from_history(hist, labels, cap)
    return dict(svc=svc, hist=hist, labels=labels, arrivals=arrivals,
                cap=cap, table=table,
                psvc=convert.service_from_numpy(service_dict(svc)))


def _port_planes(planes, budget, hold_on_stale=False):
    kw = {}
    if "emergency" in planes:
        kw["emergency"] = E.EmergencyConfig.from_model(STREAM_BUDGET_W,
                                                       dwell_s=60.0)
    if "ballooning" in planes:
        kw["ballooning"] = B.BallooningConfig()
    if "adaptive" in planes:
        kw["adaptive"] = A.AdaptiveConfig(**ADAPTIVE_KW,
                                          hold_on_stale=hold_on_stale)
    if budget:
        kw["cluster_budget"] = ResourceVector(watts=CLUSTER_W)
    return kw


def _port(world, shards, hosts, planes=(), budget=False, obs=None,
          hold_on_stale=False, chassis_w=None, mesh=False):
    """A port pipeline on the CPU over the reference's table: unsharded
    when `shards` is None; `chassis_w` a per-chassis watt budget; `mesh`,
    the shards on a CPU mesh, the table row-partitioned over it."""
    pb = PlaneBundle(obs=obs, chassis_budget=None if chassis_w is None
                     else ResourceVector(watts=chassis_w),
                     **_port_planes(planes, budget, hold_on_stale))
    if shards is None:
        cls, cfg = ServePipeline, ServeConfig(
            batch_size=CHUNK, n_ingest_hosts=hosts, planes=pb)
    else:
        cls, cfg = ShardedServePipeline, ShardedServeConfig(
            batch_size=CHUNK, n_ingest_hosts=hosts, n_shards=shards,
            planes=pb)
    kw = {"mesh": ("cpu",) * shards} if mesh else {}
    pipe = cls.from_history(world["psvc"], world["hist"], world["labels"],
                            table_capacity=world["cap"], config=cfg,
                            device="cpu", **KW, **kw)
    pipe.table = convert.table_from_numpy(table_dict(world["table"]), "cpu")
    if mesh:
        pipe.table = shard_table(pipe.table, pipe.mesh)
    return pipe


def _ref(world, rserve, shards, hosts, planes=(), budget=False, obs=None):
    rb, ra = reference_serve("ballooning"), reference_serve("adaptive")
    re = reference_serve("emergency")
    from repro.core.resources import ResourceVector as RVector
    kw = {}
    if "emergency" in planes:
        kw["emergency"] = re.EmergencyConfig.from_model(STREAM_BUDGET_W,
                                                        dwell_s=60.0)
    if "ballooning" in planes:
        kw["ballooning"] = rb.BallooningConfig()
    if "adaptive" in planes:
        kw["adaptive"] = ra.AdaptiveConfig(**ADAPTIVE_KW)
    if budget:
        kw["cluster_budget"] = RVector(watts=CLUSTER_W)
    pb = rserve.PlaneBundle(obs=obs, **kw)
    if shards is None:
        cls, cfg = rserve.ServePipeline, rserve.ServeConfig(
            kernel="ref", batch_size=CHUNK, n_ingest_hosts=hosts, planes=pb)
    else:
        cls, cfg = rserve.ShardedServePipeline, rserve.ShardedServeConfig(
            kernel="ref", batch_size=CHUNK, n_ingest_hosts=hosts,
            n_shards=shards, planes=pb)
    return cls.from_history(world["svc"], world["hist"], world["labels"],
                            table_capacity=world["cap"], config=cfg, **KW)


def _rho_levels(pipe):
    st = pipe.global_state() if hasattr(pipe, "global_state") else pipe.state
    g = [np.asarray(a.numpy() if torch.is_tensor(a) else a, np.float64)
         for a in (st.gamma_nuf, st.gamma_uf)]
    return np.stack([x.reshape(4, 12).sum(-1) for x in g], -1)


def _stream(pipe, tel, hosts, samples=None):
    """Arrival chunks dealt over `hosts`, every other admitted VM of chunk
    k-2 departing with its GB, then (when the pipeline has a plane that
    reads them) a sweep of the four chassis, one sampled twice, at the
    chunk's utilization in UTILS on the live aggregates, or HOT, or taken
    from `samples`. Returns the results, the alarms and the sweep
    powers."""
    pop = tel.generate_population(N_STREAM, seed=9)
    stamps = tel.arrival_stamps(N_STREAM)
    cores = np.array([v.cores for v in pop.vms], np.float32)
    mem = np.array([v.memory_gb for v in pop.vms], np.float32)
    sweeps = pipe.emergency_cfg is not None or \
        pipe.adaptive_cfg is not None
    results, swept = [], []
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
        if not sweeps:
            continue
        if samples is not None:
            power = samples[k]
        elif UTILS[k] is None:
            power = HOT
        else:
            power = A.offered_power(A.AdaptiveConfig(), _rho_levels(pipe),
                                    UTILS[k])
            power = np.append(power, power[1] * 0.95)
        swept.append(power)
        results += pipe.cap_to((k + 1) % hosts, [0, 1, 2, 3, 1], power,
                               t=t_end + 0.5 + (np.arange(5) + 1) * 1e-7)
        out = pipe.flush()
        results += [] if out is None else [out]
    alarms = pipe.alarms if pipe.emergency_cfg is not None else 0
    return results, alarms, swept


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("server", "workload_type", "p95_bucket", "conservative",
                  "p95_eff"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)


def _assert_snapshots_match(got, want):
    """Every series of `want` in `got` with the same labels and kind; the
    values equal, but TIME_FAMILIES (count only) and FLOAT_FAMILIES
    (counts exact, values to 1e-6 relative)."""
    assert sorted(got) == sorted(want)
    for name in want:
        assert [s["labels"] for s in got[name]] == \
            [s["labels"] for s in want[name]], name
        for a, b in zip(got[name], want[name]):
            assert a["kind"] == b["kind"], name
            if name in TIME_FAMILIES:
                assert a["count"] == b["count"], (name, a["labels"])
            elif name in FLOAT_FAMILIES:
                for k in ("value", "sum"):
                    if k in b:
                        assert a[k] == pytest.approx(b[k], rel=1e-6,
                                                     abs=1e-9), \
                            (name, a["labels"], k)
                if "count" in b:
                    assert a["count"] == b["count"], name
            else:
                assert a == b, (name, a, b)


ALL = ("emergency", "ballooning", "adaptive")
CASES = [
    # (shards, hosts, planes, cluster budget, obs-on pipeline on a mesh)
    (None, 1, ALL, False, False), (None, 4, ALL, False, False),
    (1, 1, ALL, False, False), (1, 4, ALL, False, False),
    (4, 1, ALL, True, False), (4, 4, ALL, True, False),
    # emergency alone: the cap windows ride in front of the placement
    (None, 1, ("emergency",), False, False),
    (4, 1, ("emergency",), True, False),
    (4, 1, ALL, True, True), (4, 4, ALL, True, True),
]


@pytest.mark.parametrize(
    "shards,hosts,planes,budget,mesh", CASES,
    ids=[f"{'unsharded' if s is None else f'{s}shards'}-{h}hosts-"
         f"{'all' if len(p) == 3 else p[0]}{'-mesh' if m else ''}"
         for s, h, p, _, m in CASES])
def test_obs_is_decision_neutral_and_snapshots_like_reference(
        world, rserve, shards, hosts, planes, budget, mesh):
    off = _port(world, shards, hosts, planes, budget)
    want_res, want_alarms, samples = _stream(off, PT, hosts)
    obs = P.Observability.full()
    on = _port(world, shards, hosts, planes, budget, obs=obs, mesh=mesh)
    got_res, got_alarms, _ = _stream(on, PT, hosts, samples)
    _assert_results_equal(got_res, want_res)
    assert got_alarms == want_alarms
    np.testing.assert_array_equal(on.throttled_by_level(),
                                  off.throttled_by_level())
    np.testing.assert_array_equal(np.ravel(on.adaptive_ratio),
                                  np.ravel(off.adaptive_ratio))
    for a, b in zip(on.state, off.state):
        assert torch.equal(a, b)
    if shards is not None:
        np.testing.assert_array_equal(on.pool_left_vec(),
                                      off.pool_left_vec())
        for x, y in ((on.emergency, off.emergency),
                     (on.balloon_state, off.balloon_state),
                     (on.adaptive_state, off.adaptive_state)):
            for a, b in zip(x or (), y or ()):
                assert torch.equal(a, b)
    # the reference pipeline with its own plane on the same stream
    from repro.sim import telemetry as RT
    robs = R.Observability.full()
    ref = _ref(world, rserve, shards, hosts, planes, budget, obs=robs)
    ref_res, ref_alarms, _ = _stream(ref, RT, hosts, samples)
    _assert_results_equal(got_res, ref_res)
    assert got_alarms == ref_alarms
    _assert_snapshots_match(obs.registry.snapshot(),
                            robs.registry.snapshot())
    # the audit rows, but for their wall-clock stamps
    a, b = obs.audit.tail(len(robs.audit)), robs.audit.tail(len(robs.audit))
    assert obs.audit.total_recorded == robs.audit.total_recorded == N_STREAM
    for f in a.dtype.names:
        if f != "t":
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    if "adaptive" in planes:
        a, b = obs.adaptive.tail(1024), robs.adaptive.tail(1024)
        assert len(a) == len(b) > 0
        for f in a.dtype.names:
            if f != "t":
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert obs.recorder.summary()["by_kind"] == \
        robs.recorder.summary()["by_kind"]
    np.testing.assert_array_equal(obs.recorder.decisions(),
                                  robs.recorder.decisions())
    assert {"ingest", "merge", "featurize", "infer", "place",
            "commit"} <= set(obs.tracer.totals())
    v = obs.registry.value
    servers = np.concatenate([r.server for r in got_res])
    assert v("serve_arrivals_total") == N_STREAM == len(servers)
    assert v("serve_admits_total") == (servers >= 0).sum()
    assert v("emergency_alarms_total") == got_alarms
    assert v("serve_batches_total") == N_STREAM // CHUNK


@pytest.mark.parametrize("shards", [None, 4], ids=["unsharded", "4shards"])
@pytest.mark.parametrize("hosts", [1, 4])
def test_verify_replay_reproduces_the_decisions(world, shards, hosts):
    obs = P.Observability.full()
    live = _port(world, shards, hosts, ALL, budget=shards is not None,
                 obs=obs)
    res, _, _ = _stream(live, PT, hosts)
    rec = obs.recorder
    assert not rec.wrapped and len(rec.incidents) >= 1
    assert any(r.kind == "capping" for r in rec.incident_window(
        rec.incidents[0]))
    fresh = _port(world, shards, 1, ALL, budget=shards is not None)
    got = verify_replay(rec, fresh)
    np.testing.assert_array_equal(got, np.concatenate([r.server
                                                       for r in res]))
    assert len(got) == N_STREAM


def test_direct_serve_is_scored_but_not_recorded(world):
    obs = P.Observability.full()
    pipe = _port(world, None, 1, obs=obs)
    pipe.serve(PT.arrival_batch(world["arrivals"], np.arange(40)))
    assert obs.recorder.summary()["by_kind"]["decision"] == 0
    assert obs.quality.n_scored == 40
    assert set(obs.tracer.totals()) == {"featurize", "infer", "place",
                                        "commit"}
    assert obs.registry.value("serve_dispatch_total",
                              kind="place_batch") == 2


def test_scorecard_reconciles_with_offline_evaluate(world):
    """The scorecard's high-confidence criticality confusion is
    `core.forest.evaluate`'s on the same forest, features and gate."""
    obs = P.Observability.full()
    pipe = _port(world, None, 1, obs=obs)
    batch = PT.arrival_batch(world["arrivals"], np.arange(64))
    pipe.submit_to(0, batch, t=np.arange(64, dtype=np.float64) + 1.0)
    pipe.flush()
    online = obs.quality.offline_style("crit")
    x = featurize_batch(pipe.table, batch, pad_to=64).numpy()
    y = np.asarray(batch.user_facing, np.int64)
    svc = world["psvc"]
    offline = PF.evaluate(svc.criticality, x, y,
                          confidence=svc.confidence_gate)
    assert obs.quality.n_scored == 64
    assert online["pct_high_conf"] == pytest.approx(offline["pct_high_conf"])
    assert online["accuracy_high_conf"] == pytest.approx(
        offline["accuracy_high_conf"])
    assert set(online["buckets"]) == set(offline["buckets"])
    for c, vals in online["buckets"].items():
        for k in ("recall", "precision"):
            assert vals[k] == pytest.approx(offline["buckets"][c][k]), (c, k)


def test_hot_swap_resets_the_scorecard(world):
    obs = P.Observability.full()
    pipe = _port(world, None, 1, obs=obs)
    pipe.submit_to(0, PT.arrival_batch(world["arrivals"], np.arange(32)),
                   t=np.arange(32, dtype=np.float64) + 1.0)
    assert obs.quality.n_scored == 32
    pipe.hot_swap(world["psvc"])
    assert obs.quality.n_scored == 0 and pipe.swaps == 1


@pytest.mark.parametrize("shards", [None, 4], ids=["unsharded", "4shards"])
def test_hold_on_stale_clamps_only_while_stale(world, shards):
    """A scorecard that calls every scored model stale: with
    `hold_on_stale` the applied ratio stays at `ratio_min` while the
    controller's own ratio ratchets; after a hot swap (nothing scored, so
    fresh) the next scan applies the controller's ratio. Without
    `hold_on_stale` the same scorecard changes nothing."""
    def pipeline(hold):
        card = PredictionScorecard(min_scored=8, stale_accuracy=1.01)
        obs = P.Observability(quality=card)
        pipe = _port(world, shards, 1, ("adaptive",), obs=obs,
                     hold_on_stale=hold, chassis_w=STREAM_BUDGET_W)
        return pipe, card
    pop = PT.generate_population(64, seed=9)
    runs = {}
    for hold in (True, False):
        pipe, card = pipeline(hold)
        pipe.submit_to(0, PT.arrival_batch(pop, np.arange(64)),
                       t=np.arange(64, dtype=np.float64) + 1.0)
        assert card.model_stale
        for k in range(4):
            power = A.offered_power(A.AdaptiveConfig(), _rho_levels(pipe),
                                    0.3)
            pipe.cap_to(0, [0, 1, 2, 3], power,
                        t=100.0 + k + np.arange(4) * 1e-7)
        runs[hold] = (pipe, card)
    held, free = runs[True][0], runs[False][0]
    ratio = np.ravel(held.adaptive_ratio)
    assert (ratio > 1.0).all()
    np.testing.assert_array_equal(ratio, np.ravel(free.adaptive_ratio))
    base = held._res_cap_base if shards is None \
        else held._sharded_cap_base.reshape(-1, 3)
    np.testing.assert_array_equal(held.rho_cap.numpy(), base[:, 0].numpy())
    assert (free.rho_cap > base[:, 0]).all()
    held.hot_swap(world["psvc"])              # nothing scored: fresh
    assert not runs[True][1].model_stale
    power = A.offered_power(A.AdaptiveConfig(), _rho_levels(held), 0.3)
    held.cap_to(0, [0, 1, 2, 3], power, t=200.0 + np.arange(4) * 1e-7)
    assert (held.rho_cap > base[:, 0]).all()


def test_tokens_drawn_minus_credited_is_the_pool_change(world):
    obs = P.Observability()
    pipe = _port(world, 4, 1, budget=True, obs=obs)
    pool_start = pipe._pool_tokens_left()
    a = PT.arrival_batch(world["arrivals"], np.arange(64))
    res = pipe.submit_to(0, a, t=np.arange(64, dtype=np.float64) + 1.0)
    r = res[0]
    adm = np.flatnonzero(r.server >= 0)[:8]
    pipe.depart_to(0, r.server[adm], a.cores[adm], r.p95_eff[adm],
                   r.workload_type[adm] == 1,
                   t=np.arange(len(adm), dtype=np.float64) + 100.0)
    pipe.submit_to(0, PT.arrival_batch(world["arrivals"],
                                       np.arange(64, 128)),
                   t=np.arange(64, dtype=np.float64) + 200.0)
    pool_end = pipe._pool_tokens_left()
    v = obs.registry.value
    drawn = v("serve_tokens_drawn_total")
    credited = v("serve_tokens_credited_total")
    assert drawn > 0 and credited > 0
    assert drawn - credited == pytest.approx(pool_start - pool_end,
                                             rel=1e-4)
    gauges = sum(v("serve_pool_tokens", shard=str(i)) for i in range(4))
    assert gauges == pytest.approx(pool_end, rel=1e-6)
    info = pipe.spill_info
    assert v("serve_spilled_total") == info["spilled"]
    assert v("serve_spill_admits_total") == info["spill_admitted"]
    assert v("serve_spill_rounds_total") == info["rounds"] - \
        v("serve_batches_total")
    assert v("serve_dispatch_total", kind="sharded_round") == info["rounds"]
