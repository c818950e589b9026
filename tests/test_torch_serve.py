"""The port's labeling-and-serving slice as a whole, against the JAX
reference, on the CPU: label a history, carry the JAX
`PredictionService` and `SubscriptionTable` across through
`repro_torch.convert`, build both `ServePipeline.from_history`, serve,
depart some arrivals and serve again. Every decision column must be
equal; the featurizer and table must match the reference, a table
row-partitioned over a CPU mesh (`shard_table`) too.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.core import features as RF  # noqa: E402
from repro.core.criticality import classify as r_classify  # noqa: E402
from repro.core.predictor import train_service  # noqa: E402
from repro.core.resources import ResourceVector as RVector  # noqa: E402
from repro.sim.telemetry import (arrival_batch,  # noqa: E402
                                 generate_population)

from _torch_parity import (reference_serve, service_dict,  # noqa: E402
                           table_dict)
from repro_torch import convert  # noqa: E402
from repro_torch.core import criticality as PC  # noqa: E402
from repro_torch.serve import (FAIL_POWER, PlaneBundle,  # noqa: E402
                               ResourceVector, ServeConfig, ServePipeline,
                               ShardedTable, SubscriptionTable,
                               featurize_batch, p95_bucket_torch, shard_mesh,
                               shard_table, table_from_history, update_table)
from repro_torch.serve import emergency as PE  # noqa: E402
from repro_torch.serve import mitigation as PM  # noqa: E402
from repro_torch.sim import telemetry as PT  # noqa: E402

BUDGET_W = 12 * 112.0 + 60.0 * 4.95          # per chassis, rho ceiling 60


@pytest.fixture(scope="module")
def rserve():
    return reference_serve()


@pytest.fixture(scope="module")
def world(rserve):
    pop = generate_population(600, seed=0)
    hist, arrivals = RF.split_history_arrivals(pop)
    labels = np.asarray(r_classify(jnp.asarray(hist.series)))
    p_labels = PC.classify(hist.series, device="cpu").numpy()
    np.testing.assert_array_equal(p_labels, labels)
    aggs = RF.subscription_aggregates(hist, labels)
    svc = train_service(RF.build_features(hist, aggs),
                        labels.astype(np.int64),
                        RF.p95_bucket([v.p95_util for v in hist.vms]),
                        n_trees=12)
    cap = max(v.subscription for v in pop.vms) + 8
    table = rserve.table_from_history(hist, labels, cap)
    return dict(hist=hist, arrivals=arrivals, labels=labels, aggs=aggs,
                svc=svc, table=table, cap=cap)


def test_table_from_history_matches_reference(world):
    got = table_from_history(world["hist"], world["labels"], world["cap"],
                             device="cpu")
    for f, a, b in zip(got._fields, got, world["table"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   err_msg=f)


def test_featurizer_matches_reference(world, rserve):
    table = convert.table_from_numpy(table_dict(world["table"]), "cpu")
    batch = arrival_batch(world["arrivals"])
    got = featurize_batch(table, batch, pad_to=len(batch) + 5).numpy()
    want = np.asarray(rserve.featurize_batch(world["table"], batch,
                                             pad_to=len(batch) + 5))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got[:len(batch)], RF.build_features(world["arrivals"], world["aggs"]),
        atol=1e-4)


def test_out_of_range_ids_fall_back_and_drop(world, rserve):
    table = convert.table_from_numpy(table_dict(world["table"]), "cpu")
    cap = table.capacity
    b = arrival_batch(world["arrivals"], [0, 1])
    b.subscription[:] = [cap + 5, -3]
    got = featurize_batch(table, b).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(rserve.featurize_batch(world["table"], b)))
    assert got[0, 0] == pytest.approx(RF._DEFAULT_AGG["pct_uf"])
    t2 = update_table(table, torch.tensor([cap + 5, -3, 2]), torch.ones(3),
                      torch.full((3,), 200.0), torch.full((3,), 50.0),
                      torch.full((3,), 30.0))
    j2 = rserve.update_table(world["table"], jnp.asarray([cap + 5, -3, 2]),
                             jnp.ones(3), jnp.full(3, 200.0),
                             jnp.full(3, 50.0), jnp.full(3, 30.0))
    for f, a, w in zip(t2._fields, t2, j2):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w), err_msg=f)


@pytest.mark.parametrize("n", [2, 4])
def test_shard_table_matches_reference_padded(world, rserve, n):
    """`shard_table` over a CPU mesh of n positions pads the capacity up to
    a multiple of n; `featurize_batch` equals the reference's on its table
    padded the same way (the reference's own `shard_table` needs n JAX
    devices), for ids inside, in the padded window, past it and negative;
    and `update_table` stores an id of the padded window, as the
    reference does, rather than dropping it."""
    cap = -(-world["cap"] // 4) * 4 + 1          # 4k + 1 rows: a window
    ref = rserve.table_from_history(world["hist"], world["labels"], cap)
    padded = -(-cap // n) * n
    rpad = type(ref)(*(jnp.pad(a, [(0, padded - cap)]
                               + [(0, 0)] * (a.ndim - 1)) for a in ref))
    table = shard_table(convert.table_from_numpy(table_dict(ref), "cpu"),
                        shard_mesh(n, devices=("cpu",) * n))
    assert isinstance(table, ShardedTable) and len(table.blocks) == n
    assert table.capacity == padded > cap and padded % n == 0
    assert {b.capacity for b in table.blocks} == {padded // n}

    def check(table, rtable):
        batch = arrival_batch(world["arrivals"])
        batch.subscription[:4] = [cap, padded - 1, padded, -1]
        got = featurize_batch(table, batch, pad_to=len(batch) + 3)
        want = rserve.featurize_batch(rtable, batch, pad_to=len(batch) + 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return got
    check(table, rpad)
    ids = [cap, 3, padded + 1, cap, -2]
    cols = (np.ones(5), np.full(5, 200.0), np.full(5, 50.0),
            np.full(5, 30.0))
    table = update_table(table, torch.tensor(ids),
                         *(torch.tensor(c, dtype=torch.float32)
                           for c in cols))
    rpad = rserve.update_table(rpad, jnp.asarray(ids),
                               *(jnp.asarray(c, jnp.float32) for c in cols))
    rows = SubscriptionTable(*(torch.cat(col) for col in zip(*table.blocks)))
    for f, a, w in zip(rows._fields, rows, rpad):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w), err_msg=f)
    assert rows.count[cap] == 2
    x = check(table, rpad)
    assert x[0, 2] == 2.0                 # the window row now counts 2 VMs


def test_p95_bucket_boundaries(rserve):
    from repro.serve.featurizer import p95_bucket_jnp
    vals = np.array([0.0, 1.0, 24.999, 25.0, 25.001, 50.0, 74.5, 75.0,
                     99.0, 100.0], np.float32)
    np.testing.assert_array_equal(
        p95_bucket_torch(torch.as_tensor(vals)).numpy(),
        np.asarray(p95_bucket_jnp(jnp.asarray(vals))))


def _assert_results_equal(got, want):
    for f in ("server", "workload_type", "p95_bucket", "conservative",
              "p95_eff"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("budget", [None, BUDGET_W])
def test_serve_slice_matches_reference(world, rserve, budget):
    kw = dict(n_servers=36, cores_per_server=40, blades_per_chassis=12)
    r_pipe = rserve.ServePipeline.from_history(
        world["svc"], world["hist"], world["labels"],
        table_capacity=world["cap"],
        config=rserve.ServeConfig(kernel="ref", planes=rserve.PlaneBundle(
            chassis_budget=None if budget is None else RVector(watts=budget))),
        **kw)
    p_pipe = ServePipeline.from_history(
        convert.service_from_numpy(service_dict(world["svc"])),
        world["hist"], world["labels"], table_capacity=world["cap"],
        config=ServeConfig(planes=PlaneBundle(
            chassis_budget=None if budget is None
            else ResourceVector(watts=budget))),
        device="cpu", **kw)
    # the slice's contract: the reference's table, carried across
    p_pipe.table = convert.table_from_numpy(table_dict(r_pipe.table), "cpu")
    batch = arrival_batch(generate_population(256, seed=7))
    want, got = r_pipe.serve(batch), p_pipe.serve(batch)
    _assert_results_equal(got, want)
    if budget is not None:
        assert got.n_power_rejected > 0
        assert (got.server == FAIL_POWER).sum() == want.n_power_rejected
    # depart every other admitted VM, then serve a second, ragged batch
    adm = np.flatnonzero(got.admitted)[::2]
    args = (got.server[adm], batch.cores[adm], got.p95_eff[adm],
            got.workload_type[adm] == 1)
    r_pipe.depart(*map(jnp.asarray, args))
    p_pipe.depart(*args)
    np.testing.assert_array_equal(p_pipe.state.free_cores.numpy(),
                                  np.asarray(r_pipe.state.free_cores))
    batch2 = arrival_batch(generate_population(300, seed=8))
    _assert_results_equal(p_pipe.serve(batch2), r_pipe.serve(batch2))


def test_hot_swap_and_observe(world, rserve):
    svc = convert.service_from_numpy(service_dict(world["svc"]))
    pipe = ServePipeline.from_history(
        svc, world["hist"], world["labels"], n_servers=36,
        cores_per_server=40, blades_per_chassis=12,
        table_capacity=world["cap"], device="cpu")
    batch = arrival_batch(world["arrivals"], np.arange(40))
    before = pipe._buffers[pipe._active]
    pipe.hot_swap(svc)
    assert pipe.swaps == 1 and pipe._buffers[pipe._active] is not before
    pipe.observe(world["hist"], world["labels"])
    np.testing.assert_array_equal(
        pipe.table.count.numpy(),
        2 * np.asarray(world["table"].count))
    assert pipe.serve(batch).server.shape == (40,)


@pytest.mark.parametrize("budget", [None, BUDGET_W])
def test_obs_plane_is_accepted_and_decision_neutral(world, budget):
    """`PlaneBundle(obs=Observability.full())` serves the slice's batches
    as a pipeline without it does, decision for decision, and its
    counters add up to those decisions."""
    from repro_torch.obs import Observability
    svc = convert.service_from_numpy(service_dict(world["svc"]))
    obs = Observability.full()
    pipes = [ServePipeline.from_history(
        svc, world["hist"], world["labels"], n_servers=36,
        cores_per_server=40, blades_per_chassis=12,
        table_capacity=world["cap"], device="cpu", config=ServeConfig(
            planes=PlaneBundle(obs=o, chassis_budget=None if budget is None
                               else ResourceVector(watts=budget))))
        for o in (obs, None)]
    batch = arrival_batch(generate_population(300, seed=7))
    got, want = (p.serve(batch) for p in pipes)
    _assert_results_equal(got, want)
    for a, b in zip(pipes[0].state, pipes[1].state):
        assert torch.equal(a, b)
    v = obs.registry.value
    assert v("serve_arrivals_total") == 300 == obs.quality.n_scored
    assert v("serve_admits_total") == got.n_admitted
    assert v("serve_rejects_total", reason="power") == got.n_power_rejected
    assert v("serve_conservative_total") == got.n_conservative
    assert obs.audit.total_recorded == 300


# --- the streamed loop with the power-emergency plane ---------------------

N_STREAM, CHUNK = 320, 32          # 10 micro-batches of the pipeline's 32
CAP_EVERY, MIGRATE_AT = 2, 5       # a cap sweep every 2 chunks
STREAM_BUDGET_W = 1560.0           # 216 W over the static floor


def _stream(pipe, tel, pop, hosts, samples, plan_util):
    """Push the scripted stream through a pipeline: arrival chunk k dealt
    row by row over `hosts` (unit-clock stamps), then every other
    admitted VM of micro-batch k-2 departs (from the server it is on),
    then every CAP_EVERY chunks a sweep of exogenous power samples with
    one chassis sampled twice, all stamped between arrival ticks. After
    chunk MIGRATE_AT the pipeline is flushed and one migration cycle
    runs: due chassis -> `plan_migrations` (at `plan_util`) -> paired
    events through `depart_to` -> `reset_dwell`. Returns the results and
    the plan."""
    stamps = tel.arrival_stamps(N_STREAM)
    cores = np.array([v.cores for v in pop.vms], np.float32)
    server_of = np.full(N_STREAM, -1, np.int64)
    p95_of = np.zeros(N_STREAM, np.float32)
    uf_of = np.zeros(N_STREAM, bool)
    departed = np.zeros(N_STREAM, bool)
    results, plan = [], None

    def push(out):
        for r in [] if out is None else [out] if hasattr(out, "server") \
                else out:
            rows = len(results) * CHUNK + np.arange(len(r.server))
            server_of[rows], p95_of[rows] = r.server, r.p95_eff
            uf_of[rows] = r.workload_type == 1
            results.append(r)
    for k in range(N_STREAM // CHUNK):
        idx = np.arange(k * CHUNK, (k + 1) * CHUNK)
        for h in range(hosts):
            rows = idx[idx % hosts == h]
            push(pipe.submit_to(h, tel.arrival_batch(pop, rows),
                                t=stamps[rows]))
        t_end = stamps[idx[-1]]
        if k >= 2:
            rows = (k - 2) * CHUNK + np.flatnonzero(
                results[k - 2].server >= 0)[::2]
            departed[rows] = True
            push(pipe.depart_to(
                k % hosts, server_of[rows], cores[rows], p95_of[rows],
                uf_of[rows], t=t_end + 0.25 + 1e-6 * np.arange(len(rows))))
        if k % CAP_EVERY == CAP_EVERY - 1:
            push(pipe.cap_to((k + 1) % hosts, [0, 1, 2, 1],
                             samples[k // CAP_EVERY],
                             t=t_end + 0.5 + (np.arange(4) + 1) * 1e-7))
        if k == MIGRATE_AT:
            push(pipe.flush())
            live = np.flatnonzero((server_of >= 0) & ~departed)
            due = pipe.mitigation_due_chassis()
            st = pipe.state
            f64 = (lambda a: a.double().numpy()) \
                if torch.is_tensor(st.free_cores) \
                else (lambda a: np.asarray(a, np.float64))
            plan = PM.plan_migrations(
                pipe.emergency_cfg, PM.LiveVMs(
                    server_of[live].astype(np.int32),
                    cores[live].astype(np.float64),
                    p95_of[live].astype(np.float64), uf_of[live],
                    token=live),
                np.asarray(st.chassis_of), f64(st.free_cores),
                PE.chassis_rho_levels_np(f64(st.gamma_nuf),
                                         f64(st.gamma_uf),
                                         np.asarray(st.chassis_servers)),
                plan_util, np.isin(np.arange(pipe.n_chassis), due))
            dep, arr = plan.as_events()
            t_dep, t_arr = plan.paired_stamps(t_end + 0.75)
            for i in range(len(plan)):
                for ev, t in ((dep, t_dep), (arr, t_arr)):
                    push(pipe.depart_to(
                        i % hosts, ev.server[i:i + 1], ev.cores[i:i + 1],
                        ev.p95_eff[i:i + 1], ev.is_uf[i:i + 1],
                        t=t[i:i + 1]))
            server_of[plan.token] = plan.dst_server
            pipe.reset_dwell(due)
    push(pipe.flush())
    return results, plan


def _stream_pipes(world, rserve, hosts):
    kw = dict(n_servers=36, cores_per_server=40, blades_per_chassis=12)
    cfg = PE.EmergencyConfig.from_model(STREAM_BUDGET_W, dwell_s=60.0)
    if hosts is None:
        RE = reference_serve("emergency")
        return rserve.ServePipeline.from_history(
            world["svc"], world["hist"], world["labels"],
            table_capacity=world["cap"], config=rserve.ServeConfig(
                kernel="ref", batch_size=CHUNK, planes=rserve.PlaneBundle(
                    emergency=RE.EmergencyConfig.from_model(
                        STREAM_BUDGET_W, dwell_s=60.0))), **kw)
    pipe = ServePipeline.from_history(
        convert.service_from_numpy(service_dict(world["svc"])),
        world["hist"], world["labels"], table_capacity=world["cap"],
        config=ServeConfig(batch_size=CHUNK, n_ingest_hosts=hosts,
                           planes=PlaneBundle(emergency=cfg)),
        device="cpu", **kw)
    return pipe


def test_streamed_serve_with_emergencies_matches_reference(world, rserve):
    """Arrivals, departures, cap sweeps and one migration cycle pushed
    through `submit_to`/`depart_to`/`cap_to`/`flush` (float32): the
    port's decisions, alarms, throttled-seconds, due chassis and plan
    equal the reference pipeline's (`kernel="ref"`), and equal across 1
    and 3 ingest hosts; the final cluster state equals the reference's
    in its core counts and within float32 rounding (rtol 1e-6) in its
    watt sums, whose order of addition XLA chooses."""
    from repro.sim import telemetry as RT
    samples = np.random.default_rng(21).uniform(
        1450.0, 1750.0, (N_STREAM // CHUNK // CAP_EVERY, 4))
    runs = {}
    for name, hosts in (("ref", None), ("port1", 1), ("port3", 3)):
        pipe = _stream_pipes(world, rserve, hosts)
        if hosts is not None:
            pipe.table = convert.table_from_numpy(
                table_dict(runs["ref"][0].table), "cpu")
        tel = RT if hosts is None else PT
        pop = tel.generate_population(N_STREAM, seed=9)
        res, plan = _stream(pipe, tel, pop, hosts or 1, samples, 0.45)
        runs[name] = (pipe, res, plan)
    ref, res_ref, plan_ref = runs["ref"]
    assert sum(len(r.server) for r in res_ref) == N_STREAM
    assert ref.alarms > 0 and len(plan_ref) > 0
    for name in ("port1", "port3"):
        pipe, res, plan = runs[name]
        assert len(res) == len(res_ref), name
        for got, want in zip(res, res_ref):
            _assert_results_equal(got, want)
        assert pipe.alarms == ref.alarms, name
        np.testing.assert_array_equal(pipe.throttled_by_level(),
                                      ref.throttled_by_level())
        for f in ("src_server", "dst_server", "token", "cores"):
            np.testing.assert_array_equal(getattr(plan, f),
                                          getattr(plan_ref, f))
        np.testing.assert_array_equal(pipe.state.free_cores.numpy(),
                                      np.asarray(ref.state.free_cores))
        for f in ("gamma_uf", "gamma_nuf", "res_peak"):
            np.testing.assert_allclose(getattr(pipe.state, f).numpy(),
                                       np.asarray(getattr(ref.state, f)),
                                       rtol=1e-6, err_msg=f)
        for f, a, b in zip(pipe.emergency._fields, pipe.emergency,
                           ref.emergency):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
    one, three = runs["port1"][0], runs["port3"][0]
    for f in ("free_cores", "gamma_uf", "gamma_nuf", "res_peak"):
        assert torch.equal(getattr(one.state, f), getattr(three.state, f)), f
    assert one.served == three.served == N_STREAM


def test_streamed_entry_points_refuse_misuse(world):
    pipe = ServePipeline.from_history(
        convert.service_from_numpy(service_dict(world["svc"])),
        world["hist"], world["labels"], n_servers=36, cores_per_server=40,
        blades_per_chassis=12, table_capacity=world["cap"],
        config=ServeConfig(n_ingest_hosts=2), device="cpu")
    batch = arrival_batch(generate_population(4, seed=1))
    with pytest.raises(ValueError, match="submit_to"):
        pipe.submit(batch)
    with pytest.raises(ValueError, match="depart_to"):
        pipe.depart([0], [1.0], [0.5], [True])
    with pytest.raises(ValueError, match="PlaneBundle.emergency"):
        pipe.cap_to(0, [0], [2000.0])
    assert pipe.submit_to(0, batch, t=np.arange(1.0, 5.0)) == []
    assert pipe.flush().server.shape == (4,)
    assert pipe.throttled_by_level().tolist() == [0.0, 0.0]
    assert len(pipe.mitigation_due_chassis()) == 0
    with pytest.raises(ValueError, match="blades_per_chassis"):
        ServePipeline.from_history(
            convert.service_from_numpy(service_dict(world["svc"])),
            world["hist"], world["labels"], n_servers=36,
            cores_per_server=40, blades_per_chassis=12,
            table_capacity=world["cap"], device="cpu",
            config=ServeConfig(planes=PlaneBundle(
                emergency=PE.EmergencyConfig.from_model(
                    1480.0, blades_per_chassis=6))))
