"""The port's adaptive oversubscription controller
(`repro_torch.serve.adaptive`), `PlaneBundle.adaptive` and
`SimSpec.adaptive` against the JAX package's, on the CPU.

- The numpy oracle is array-equal to the reference's numpy call over a
  randomized stream that ratchets and backs off, in float32 and float64,
  and the torch twin is bit-equal to the oracle, scan for scan.
- The controller behaves as the reference's tests say: 1.0 with no
  history, no move before `min_history`, ratchets to the ceiling on a
  steady stream, backs off fast on a hot chassis, pins the floor on a
  thrashing stream, keeps unmasked windows, rejects a wide band;
  `retarget_pool` conserves tokens; `decision_reason` covers every
  branch.
- A pipeline with the controller scales `rho_cap` by its ratio and
  decides as the reference pipeline does, at 1 and 4 ingest hosts.
- The sim's serve backend with the controller gives the reference's
  trace and every `SimMetrics` field (its twin checked on every scan).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (reference_enable_x64, reference_serve,
                           service_dict, table_dict)
from repro_torch import convert
from repro_torch.core.placement import SchedulerPolicy
from repro_torch.core.resources import ResourceVector
from repro_torch.serve import adaptive as A
from repro_torch.serve import (PlaneBundle, ServeConfig, ServePipeline)
from repro_torch.sim import scheduler_sim as S
from repro_torch.sim import telemetry as PT

C = 6              # chassis in the controller-level tests


@pytest.fixture(scope="module")
def ra():
    return reference_serve("adaptive")


def _cfg(mod=A, **kw):
    kw.setdefault("window", 8)
    kw.setdefault("min_history", 3)
    return mod.AdaptiveConfig(**kw)


def _scan_stream(cfg, utils, twin=False, dtype=np.float64):
    """Step a C-chassis controller through a (T, C) utilization stream
    (powers from `offered_power`, the sim's feed) on the oracle or the
    twin, returning the final state and the per-scan outputs."""
    rho_lv = np.full((C, 2), 40.0, dtype)
    if twin:
        st = A.init_adaptive(cfg, C, dtype=torch.float64, device="cpu")
    else:
        st = A.init_adaptive_np(cfg, C, dtype=dtype)
    outs = []
    for u in utils:
        pw = np.asarray(A.offered_power(cfg, rho_lv,
                                           np.asarray(u, dtype)), dtype)
        if twin:
            st, out = A.adaptive_step(cfg, st, torch.as_tensor(rho_lv),
                                      torch.as_tensor(pw),
                                      torch.ones(C, dtype=torch.bool))
        else:
            st, out = A.adaptive_step_np(cfg, st, rho_lv, pw,
                                         np.ones(C, bool))
        outs.append(out)
    return st, outs


@pytest.fixture(params=["oracle", "twin"])
def twin(request):
    return request.param == "twin"


def _reason(before, out):
    return A.REASON_NAMES[A.decision_reason(
        before, float(out.ratio), int(out.n_known), bool(out.ratchet),
        bool(out.backoff), bool(out.hot))]


def test_config_validation():
    for kw in (dict(window=1), dict(window=8, min_history=9),
               dict(spread_q_lo=0.9, spread_q_hi=0.1),
               dict(backoff_quorum=0.95, ratchet_quorum=0.9),
               dict(ratio_min=2.0, ratio_max=1.5), dict(step_up=0.0)):
        with pytest.raises(ValueError):
            A.AdaptiveConfig(**kw)
    assert A.AdaptiveConfig.from_model().static_w == pytest.approx(
        12 * 112.0)


def test_zero_history_holds_ratio_one(twin):
    cfg = _cfg()
    rho = np.full((C, 2), 40.0)
    if twin:
        st, out = A.adaptive_step(
            cfg, A.init_adaptive(cfg, C, dtype=torch.float64, device="cpu"),
            torch.as_tensor(rho), torch.full((C,), 500.0, dtype=torch.float64),
            torch.zeros(C, dtype=torch.bool))
    else:
        st, out = A.adaptive_step_np(cfg, A.init_adaptive_np(cfg, C), rho,
                                     np.full(C, 500.0), np.zeros(C, bool))
    assert float(out.ratio) == 1.0
    assert int(out.n_known) == 0 and not bool(out.backoff)
    assert _reason(1.0, out) == "hold_no_history"


def test_min_history_gates_the_first_decision(twin):
    _, outs = _scan_stream(_cfg(min_history=4), [np.full(C, 0.4)] * 3, twin)
    assert all(float(o.ratio) == 1.0 for o in outs)
    assert int(outs[-1].n_known) == 0


def test_steady_windows_ratchet_to_ceiling(twin):
    st, outs = _scan_stream(_cfg(step_up=0.25, ratio_max=1.6),
                            [np.full(C, 0.4)] * 8, twin)
    ratios = [float(o.ratio) for o in outs]
    assert ratios[1] == 1.0
    assert ratios[-1] == pytest.approx(1.6)
    assert int(st.ratchets) >= 3
    assert _reason(1.6, outs[-1]) == "ratchet_ceiling"


def test_hot_sample_backs_off_fast(twin):
    hot = np.full(C, 0.4)
    hot[2] = 0.95
    _, outs = _scan_stream(_cfg(step_up=0.05, step_down=0.25, ratio_max=3.0),
                           [np.full(C, 0.4)] * 6 + [hot], twin)
    before, after = float(outs[-2].ratio), float(outs[-1].ratio)
    assert bool(outs[-1].hot) and bool(outs[-1].backoff)
    assert after == pytest.approx(max(before - 0.25, 1.0))
    assert _reason(before, outs[-1]) == "backoff_hot"


def test_oscillating_windows_pin_the_floor(twin):
    utils = [np.full(C, 0.3 + 0.2 * (k % 2)) for k in range(10)]
    st, outs = _scan_stream(_cfg(flip_thresh=0.5), utils, twin)
    assert all(float(o.ratio) == 1.0 for o in outs)
    assert int(outs[-1].n_known) == C and bool(outs[-1].backoff)
    assert _reason(1.0, outs[-1]) == "backoff_floor"
    assert int(st.backoffs) > 0


def test_masked_chassis_keep_their_windows(twin):
    cfg = _cfg()
    rho = np.full((C, 2), 40.0)
    mask = np.ones(C, bool)
    mask[0] = False
    pw = np.asarray(A.offered_power(cfg, rho, 0.4))
    if twin:
        st, _ = A.adaptive_step(
            cfg, A.init_adaptive(cfg, C, dtype=torch.float64, device="cpu"),
            torch.as_tensor(rho), torch.as_tensor(pw), torch.as_tensor(mask))
        count = st.count.numpy()
    else:
        st, _ = A.adaptive_step_np(cfg, A.init_adaptive_np(cfg, C), rho, pw,
                                   mask)
        count = st.count
    assert count[0] == 0 and (count[1:] == 1).all()


def test_spread_assesser_rejects_wide_band(twin):
    ramp = [np.full(C, 0.12 * k) for k in range(8)]
    _, outs = _scan_stream(_cfg(spread_thresh=0.1, flip_thresh=1.0), ramp,
                           twin)
    assert int(outs[-1].n_stable) == 0
    assert all(float(o.ratio) == 1.0 for o in outs)


def _mixed_stream(rng, dtype, steps=40):
    """Utilization that settles, thrashes, runs hot and cools again, so a
    controller with `_cfg(ratio_max=3.0, hot_util=0.7)` both ratchets and
    backs off."""
    out = []
    for k in range(steps):
        phase = (k // 10) % 4
        if phase == 1:                    # thrashing
            u = 0.4 + 0.25 * (-1) ** k + rng.uniform(-0.01, 0.01, C)
        elif phase == 2:                  # hot
            u = 0.9 + rng.uniform(-0.05, 0.05, C)
        else:                             # calm, slowly trending
            u = 0.35 + 0.002 * k + rng.uniform(0.0, 0.001, C)
        out.append(u.astype(dtype))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_oracle_matches_reference_and_twin_is_bit_equal(ra, dtype):
    """Masked writes, percentile gathers, flip counts and the fleet
    reduction over a randomized stream: the oracle equals the reference's
    numpy call and the twin equals the oracle, every state and output
    field, every scan; the stream ratchets and backs off."""
    rng = np.random.default_rng(0)
    kw = dict(ratio_max=3.0, hot_util=0.7)
    cfg, rcfg = _cfg(**kw), _cfg(ra, **kw)
    rho = rng.uniform(5.0, 80.0, (C, 2)).astype(dtype)
    rho[0] = 0.0                          # an empty chassis reads idle
    stn = A.init_adaptive_np(cfg, C, dtype=dtype)
    str_ = ra.init_adaptive(rcfg, C, xp=np, dtype=dtype)
    stt = A.state_to_torch(stn, "cpu")
    for u in _mixed_stream(rng, dtype):
        mask = rng.random(C) < 0.8
        pw = np.asarray(A.offered_power(cfg, rho, u), dtype)
        np.testing.assert_array_equal(
            pw, np.asarray(ra.offered_power(rcfg, rho, u, np), dtype))
        stn, outn = A.adaptive_step_np(cfg, stn, rho, pw, mask)
        str_, outr = ra.adaptive_step(rcfg, str_, rho, pw, mask, np)
        stt, outt = A.adaptive_step(cfg, stt, torch.as_tensor(rho),
                                    torch.as_tensor(pw),
                                    torch.as_tensor(mask))
        for name, a, b, c in zip(stn._fields, stn, str_, stt):
            np.testing.assert_array_equal(a, b, err_msg=name)
            np.testing.assert_array_equal(c.numpy(), a, err_msg=name)
            assert c.numpy().dtype == np.asarray(a).dtype, name
        for name, a, b, c in zip(outn._fields, outn, outr, outt):
            np.testing.assert_array_equal(a, b, err_msg=name)
            np.testing.assert_array_equal(c.numpy(), a, err_msg=name)
    assert int(stn.ratchets) > 0 and int(stn.backoffs) > 0


def test_retarget_pool_mints_and_retires_only_free_tokens(ra):
    cfg = _cfg()
    assert float(A.retarget_pool(cfg, 100.0, 1.5, 40.0)) == \
        pytest.approx(110.0)
    assert float(A.retarget_pool(cfg, 100.0, 1.0, 120.0)) == 0.0
    rng = np.random.default_rng(1)
    base = np.array([80.0, 120.0, 60.0, 140.0])
    committed = np.zeros(4)
    for _ in range(50):
        ratio = float(rng.uniform(1.0, 3.0))
        free = A.retarget_pool(cfg, base, ratio, committed)
        np.testing.assert_array_equal(
            free, ra.retarget_pool(_cfg(ra), base, ratio, committed, np))
        np.testing.assert_allclose(committed + free,
                                   np.maximum(base * ratio, committed))
        committed = committed + rng.uniform(0, 1, 4) * free
        committed = np.maximum(committed - rng.uniform(0, 10, 4), 0.0)


def test_decision_reason_covers_every_branch(ra):
    cases = {
        "hold_no_history": (1.0, 1.0, 0, False, False, False),
        "hold_band": (1.2, 1.2, 5, False, False, False),
        "ratchet_quorum": (1.2, 1.25, 5, True, False, False),
        "ratchet_ceiling": (2.0, 2.0, 5, True, False, False),
        "backoff_hot": (1.5, 1.25, 5, False, True, True),
        "backoff_quorum": (1.5, 1.25, 5, False, True, False),
        "backoff_floor": (1.0, 1.0, 5, False, True, True),
    }
    assert A.REASON_NAMES == ra.REASON_NAMES
    for name, args in cases.items():
        assert A.REASON_NAMES[A.decision_reason(*args)] == name
        assert A.decision_reason(*args) == ra.decision_reason(*args)


def test_gate_ratio_on_stale():
    cfg = _cfg(ratio_min=1.0)
    assert float(A.gate_ratio_on_stale(cfg, np.float32(2.5), False)) == 2.5
    assert float(A.gate_ratio_on_stale(cfg, np.float32(2.5), True)) == 1.0
    t = torch.tensor([2.5, 0.5])
    assert A.gate_ratio_on_stale(cfg, t, True).tolist() == [1.0, 0.5]
    assert A.gate_ratio_on_stale(cfg, t, False) is t


# --- pipeline -------------------------------------------------------------

PIPE_KW = dict(n_servers=48, cores_per_server=40, blades_per_chassis=12)
N_STREAM, CHUNK = 192, 32


@pytest.fixture(scope="module")
def world():
    from repro.core import features as RF
    from repro.core.predictor import train_service
    from repro.sim.telemetry import generate_population
    pop = generate_population(400, seed=0)
    hist, _ = RF.split_history_arrivals(pop)
    labels = hist.labels.astype(np.float64)
    aggs = RF.subscription_aggregates(hist, labels)
    svc = train_service(RF.build_features(hist, aggs),
                        labels.astype(np.int64),
                        RF.p95_bucket([v.p95_util for v in hist.vms]),
                        n_trees=12)
    return dict(svc=svc, hist=hist, labels=labels,
                cap=max(v.subscription for v in pop.vms) + 64)


def _pipe(world, acfg, hosts=1, budget=None):
    return ServePipeline.from_history(
        convert.service_from_numpy(service_dict(world["svc"])),
        world["hist"], world["labels"], table_capacity=world["cap"],
        device="cpu", config=ServeConfig(
            batch_size=CHUNK, n_ingest_hosts=hosts, planes=PlaneBundle(
                adaptive=acfg, chassis_budget=budget)), **PIPE_KW)


def test_pipeline_ratio_ratchets_and_scales_rho_cap(world):
    """Full-fleet constant sweeps of an empty cluster read util 0, every
    window settles, and the ratio ratchets; the watts ceiling is the base
    times the ratio and the other axes stay as they were."""
    pipe = _pipe(world, _cfg(ratio_max=2.0),
                 budget=ResourceVector(watts=1860.0, cores=400.0))
    base = pipe.res_cap.clone()
    idx = np.arange(4)
    for k in range(6):
        pipe.cap_to(0, idx, np.full(4, 500.0),
                    t=k + 1.0 + (idx + 1) * 1e-7)
    pipe.flush()
    r = pipe.adaptive_ratio
    assert r > 1.0 and int(pipe.adaptive_state.ratchets) > 0
    np.testing.assert_array_equal(pipe.rho_cap.numpy(),
                                  (base[:, 0] * torch.tensor(r)).numpy())
    assert torch.equal(pipe.res_cap[:, 1:], base[:, 1:])
    pipe.set_resource_ratios([1.0, 1.5, 1.0])
    np.testing.assert_array_equal(pipe.res_cap[:, 1].numpy(),
                                  (base[:, 1] * 1.5).numpy())
    with pytest.raises(ValueError, match="watts"):
        pipe.set_resource_ratios([1.1, 1.0, 1.0])
    with pytest.raises(ValueError, match="shape"):
        pipe.set_resource_ratios([1.0, 1.0])


def test_cap_to_accepted_with_adaptive_only(world):
    pipe = _pipe(world, _cfg())
    pipe.cap_to(0, [0], [500.0])
    pipe.flush()
    assert int(pipe.adaptive_state.count[0]) == 1
    assert pipe.emergency is None
    bare = _pipe(world, None)
    with pytest.raises(ValueError, match="PlaneBundle.adaptive"):
        bare.cap_to(0, [0], [500.0])
    assert bare.adaptive_ratio == 1.0 and bare.adaptive_state is None


def test_blades_per_chassis_mismatch_raises(world):
    with pytest.raises(ValueError, match="blades_per_chassis"):
        _pipe(world, _cfg(blades_per_chassis=10))


def _adaptive_stream(pipe, tel, hosts, utils):
    """Arrival chunks dealt over `hosts` under a tight watt budget, and
    after each chunk three sweeps of all 4 chassis at the chunk's
    utilization (powers offered on the live aggregates) between arrival
    ticks. Returns the results and the ratio after each chunk."""
    pop = tel.generate_population(N_STREAM, seed=9)
    stamps = tel.arrival_stamps(N_STREAM)
    results, ratios = [], []
    idx4 = np.arange(4)
    for k in range(N_STREAM // CHUNK):
        idx = np.arange(k * CHUNK, (k + 1) * CHUNK)
        for h in range(hosts):
            rows = idx[idx % hosts == h]
            results += pipe.submit_to(h, tel.arrival_batch(pop, rows),
                                      t=stamps[rows])
        out = pipe.flush()
        results += [] if out is None else [out]
        st = pipe.state
        g = lambda a: np.asarray(a, np.float64) if not torch.is_tensor(a) \
            else a.double().numpy()
        rho = np.stack([g(st.gamma_nuf).reshape(4, 12).sum(-1),
                        g(st.gamma_uf).reshape(4, 12).sum(-1)], -1)
        power = A.offered_power(A.AdaptiveConfig(), rho, utils[k])
        t_end = stamps[idx[-1]]
        for rep in range(3):
            results += pipe.cap_to(
                (k + rep) % hosts, idx4, power,
                t=t_end + 0.1 * (rep + 1) + (idx4 + 1) * 1e-7)
        # with several hosts the watermark holds the sweeps back until
        # every host's clock passes them: flush to read the ratio now
        assert pipe.flush() is None
        ratios.append(pipe.adaptive_ratio)
    return results, ratios


def test_pipeline_adaptive_matches_reference(world, ra):
    """A filling cluster under a 2x watt budget, swept three times after
    every chunk at a utilization that is calm, then hot, then calm
    (float32): the port's decisions and ratios equal the reference
    pipeline's (`kernel="ref"`) at 1 and 4 ingest hosts, the controller
    state is bit-equal to the reference's, and the stream both ratchets
    and backs off."""
    rserve = reference_serve()
    from repro.core.resources import ResourceVector as RVector
    from repro.sim import telemetry as RT
    kw = dict(ratio_max=3.0, hot_util=0.7, min_history=2)
    utils = [0.3, 0.3, 0.3, 0.9, 0.3, 0.3]
    ref = rserve.ServePipeline.from_history(
        world["svc"], world["hist"], world["labels"],
        table_capacity=world["cap"], config=rserve.ServeConfig(
            kernel="ref", batch_size=CHUNK, planes=rserve.PlaneBundle(
                adaptive=_cfg(ra, **kw),
                chassis_budget=RVector(watts=1860.0))), **PIPE_KW)
    want, want_r = _adaptive_stream(ref, RT, 1, utils)
    st = ref.adaptive_state
    assert int(st.ratchets) > 0 and int(st.backoffs) > 0
    for hosts in (1, 4):
        pipe = _pipe(world, _cfg(**kw), hosts,
                     budget=ResourceVector(watts=1860.0))
        pipe.table = convert.table_from_numpy(table_dict(ref.table), "cpu")
        got, got_r = _adaptive_stream(pipe, PT, hosts, utils)
        assert got_r == want_r
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.server, w.server)
            np.testing.assert_array_equal(g.conservative, w.conservative)
        for name, a, b in zip(st._fields, pipe.adaptive_state, st):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
        np.testing.assert_array_equal(pipe.rho_cap.numpy(),
                                      np.asarray(ref.rho_cap))


# --- sim ------------------------------------------------------------------

SIM_KW = dict(days=0.08, seed=3, deployments_per_hour=16.0,
              prefill_core_ratio=0.5)


def test_sim_adaptive_requires_serve_backend():
    with pytest.raises(ValueError, match="serve"):
        S.simulate(SchedulerPolicy(), S.PredictionChannel("ml"),
                   S.SimSpec(adaptive=_cfg(), **SIM_KW), device="cpu")


def test_sim_adaptive_matches_reference(monkeypatch, ra):
    """The reference test's short serve-backend run with the controller:
    the trace and every `SimMetrics` field equal the reference's, the
    twin held bit-equal to the oracle on every scan, and the ratio moves
    off 1.0."""
    from repro.core.placement import SchedulerPolicy as RPolicy
    from repro.core.resources import ResourceVector as RVector
    from repro.sim import scheduler_sim as RS
    reference_enable_x64(monkeypatch)
    tr_p, tr_r = [], []
    got = S.simulate(SchedulerPolicy(), S.PredictionChannel("ml"), S.SimSpec(
        serve=S.ServeBackendSpec(
            backend="serve",
            admission_budget=ResourceVector(watts=12 * 310.0 / 2)),
        adaptive=_cfg(ratio_max=3.0), **SIM_KW), trace=tr_p, device="cpu")
    want = RS.simulate(RPolicy(), RS.PredictionChannel("ml"), RS.SimSpec(
        serve=RS.ServeBackendSpec(
            backend="serve",
            admission_budget=RVector(watts=12 * 310.0 / 2)),
        adaptive=_cfg(ra, ratio_max=3.0), **SIM_KW), trace=tr_r)
    assert tr_p == tr_r
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.adaptive_ratio > 1.0 and got.adaptive_ratchets > 0
    assert got.placements > 0
