"""The port's observability pillars (`repro_torch.obs`) against the JAX
package's (`repro.obs`), on the CPU: the same seeded numpy inputs through
both must give the same registry snapshot and Prometheus text (as
strings), histogram quantiles, PSI, audit rows, window, SLO and scorecard
summaries (as sorted JSON), and the same flight-recorder eviction and
refusal to replay a wrapped stream. `repro.obs` imports no JAX; where the
reference reads `repro.serve` (the adaptive reason names) it is reached
through `_torch_parity.reference_serve`.
"""
import json
import math

import numpy as np
import pytest

from repro import obs as R
from repro.obs import quality as RQ
from repro.obs import recorder as RR
from repro.obs import slo as RS
from repro.obs import windows as RW

from _torch_parity import reference_serve
from repro_torch import obs as P
from repro_torch.obs import quality as PQ
from repro_torch.obs import recorder as PR
from repro_torch.obs import slo as PS
from repro_torch.obs import windows as PW

SEEDS = (0, 1, 2)


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


# --- registry -------------------------------------------------------------

def _fill_registry(reg, seed):
    """One seeded sequence of counter, gauge and histogram updates."""
    rng = np.random.default_rng(seed)
    for i in range(40):
        reg.counter("hits_total", help="hits",
                    reason=["a", "b", "c"][i % 3]).inc(
                        float(rng.integers(0, 5)))
        reg.gauge("level", shard=str(i % 4)).set(float(rng.normal()))
        reg.histogram("lat_seconds", help="latency").observe(
            float(rng.lognormal(-5.0, 2.0)))
        reg.histogram("watts", lo=1.0, base=1.5, n_buckets=20).observe(
            float(rng.uniform(0.0, 5000.0)))
    reg.gauge("level", shard="0").dec(2.5)
    reg.counter("plain_total").inc()
    return reg


@pytest.mark.parametrize("seed", SEEDS)
def test_registry_snapshot_and_prometheus_match(seed):
    got = _fill_registry(P.MetricsRegistry(), seed)
    want = _fill_registry(R.MetricsRegistry(), seed)
    assert got.to_json() == want.to_json()
    assert got.to_prometheus() == want.to_prometheus()
    assert got.value("hits_total", reason="b") == \
        want.value("hits_total", reason="b")
    assert got.value("absent_total") == want.value("absent_total") == 0.0


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantiles_match(q):
    got = _fill_registry(P.MetricsRegistry(), 5)
    want = _fill_registry(R.MetricsRegistry(), 5)
    for name in ("lat_seconds", "watts"):
        assert got.histogram(name).quantile(q) == \
            want.histogram(name).quantile(q), name
    assert math.isnan(P.MetricsRegistry().histogram("h").quantile(q))


def test_registry_refusals_match():
    for mod in (P, R):
        reg = mod.MetricsRegistry()
        c = reg.counter("x_total")
        for bad in (-1.0, float("nan")):
            with pytest.raises(ValueError):
                c.inc(bad)
        with pytest.raises(TypeError):
            reg.gauge("x_total")
        with pytest.raises(ValueError):
            reg.histogram("h", lo=0.0)


def test_level_names_follow_the_emergency_level_order():
    from repro_torch.serve import CRIT_NUF, CRIT_UF, N_LEVELS
    assert P.LEVEL_NAMES == R.LEVEL_NAMES
    assert P.LEVEL_NAMES[CRIT_NUF] == "nuf"
    assert P.LEVEL_NAMES[CRIT_UF] == "uf"
    assert len(P.LEVEL_NAMES) == N_LEVELS


# --- psi ------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", [2, 4, 10])
def test_psi_matches(seed, k):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, 50, k).astype(np.float64)
    a = rng.integers(0, 50, k).astype(np.float64)
    e[0] = 0.0                      # an empty bucket stays finite
    assert PQ.psi(e, a) == RQ.psi(e, a)
    assert PQ.psi(e, e) == RQ.psi(e, e)


# --- audit ----------------------------------------------------------------

def _fill_audit(trail, seed, batches=6, b=7):
    rng = np.random.default_rng(seed)
    for k in range(batches):
        servers = rng.integers(-3, 48, b)
        trail.record_batch(
            t=float(k), batch=k, servers=servers,
            chassis=np.where(servers >= 0, servers // 12, -1),
            rule=int(rng.integers(0, 3)), cores=rng.integers(1, 9, b),
            is_uf=rng.random(b) < 0.4, p95_eff=rng.random(b),
            valid=rng.random(b) < 0.85, conservative=rng.random(b) < 0.2,
            pool_left=float(rng.uniform(0, 100)))
    return trail


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("capacity", [8, 64])
def test_audit_tail_and_explain_match(seed, capacity):
    got = _fill_audit(P.AuditTrail(capacity), seed)
    want = _fill_audit(R.AuditTrail(capacity), seed)
    assert len(got) == len(want)
    assert got.total_recorded == want.total_recorded
    for n in (1, 5, len(want)):
        a, b = got.tail(n), want.tail(n)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    last = want.total_recorded - 1
    assert got.explain(last).describe() == want.explain(last).describe()
    assert [r.describe() for r in got.rejected(6)] == \
        [r.describe() for r in want.rejected(6)]
    with pytest.raises(KeyError):
        got.explain(want.total_recorded)


def _fill_adaptive(trail, seed):
    rng = np.random.default_rng(seed)
    for i in range(12):
        trail.record(t=float(i), shard=int(rng.integers(-1, 4)),
                     ratio=float(rng.uniform(1, 2)),
                     stable_frac=float(rng.random()),
                     n_known=int(rng.integers(0, 60)),
                     n_stable=int(rng.integers(0, 60)),
                     action=int(rng.integers(-1, 2)),
                     reason=int(rng.integers(0, 8)))
    return trail


@pytest.mark.parametrize("seed", SEEDS)
def test_adaptive_trail_matches(seed):
    reference_serve("adaptive")             # the reference's reason names
    got = _fill_adaptive(P.AdaptiveTrail(capacity=8), seed)
    want = _fill_adaptive(R.AdaptiveTrail(capacity=8), seed)
    np.testing.assert_array_equal(got.tail(8), want.tail(8))
    for seq in range(4, 12):
        g, w = got.explain(seq), want.explain(seq)
        assert g.describe() == w.describe()
        assert g.reason_name == w.reason_name
    assert [r.describe() for r in got.backoffs()] == \
        [r.describe() for r in want.backoffs()]


def test_outcome_names_match():
    assert P.OUTCOME_NAMES == R.OUTCOME_NAMES


# --- windows --------------------------------------------------------------

def _fill_windows(mod, wmod, seed):
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    plane = wmod.WindowPlane(registry=reg, width=30.0, rolling=90.0,
                             keep=4)
    t = 0.0
    for _ in range(60):
        t += float(rng.exponential(7.0))
        name = ["arrivals", "admits", "cut_watts"][int(rng.integers(0, 3))]
        plane.observe(t, name, float(rng.uniform(0, 10)),
                      n=int(rng.integers(1, 4)))
        plane.observe_hist("cut_watts", float(rng.uniform(-1, 2.1e4)),
                           lo=0.0, hi=2.0e4)
        if rng.random() < 0.3:
            plane.advance(t)
        if rng.random() < 0.1:
            plane.observe(t - 200.0, "arrivals")     # a late event
    plane.advance(t + 1.0)
    return plane, reg


@pytest.mark.parametrize("seed", SEEDS)
def test_window_plane_summary_matches(seed):
    got, greg = _fill_windows(P, PW, seed)
    want, wreg = _fill_windows(R, RW, seed)
    assert _dumps(got.summary()) == _dumps(want.summary())
    assert greg.to_json() == wreg.to_json()


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.99, 1.0])
def test_fixed_histogram_matches(q):
    rng = np.random.default_rng(3)
    vals = np.concatenate([rng.uniform(-2, 12, 50), [np.nan, 25.0]])
    got, want = PW.FixedHistogram(0.0, 10.0, 10), \
        RW.FixedHistogram(0.0, 10.0, 10)
    for v in vals:
        got.observe(v)
        want.observe(v)
    assert got.quantile(q) == want.quantile(q)
    assert _dumps(got.snapshot()) == _dumps(want.snapshot())


def test_tumbling_and_rolling_windows_match():
    rng = np.random.default_rng(4)
    pairs = [(PW.TumblingWindow(10.0, keep=3),
              RW.TumblingWindow(10.0, keep=3)),
             (PW.RollingWindow(25.0), RW.RollingWindow(25.0))]
    t = 0.0
    for _ in range(80):
        t += float(rng.exponential(3.0))
        v = float(rng.normal())
        for got, want in pairs:
            got.observe(t, v)
            want.observe(t, v)
        if rng.random() < 0.2:
            for got, want in pairs:
                a, b = got.advance(t), want.advance(t)
                if a is not None:
                    assert [w.as_dict() for w in a] == \
                        [w.as_dict() for w in b]
    (gt, wt), (gr, wr) = pairs
    assert gt.late == wt.late
    assert [w.as_dict() for w in gt.closed] == \
        [w.as_dict() for w in wt.closed]
    assert (gr.sum, gr.count, gr.rate) == (wr.sum, wr.count, wr.rate)


# --- SLO monitor ----------------------------------------------------------

def _fill_slo(mod, smod, seed, rules=None):
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    mon = smod.SLOMonitor(rules=rules, registry=reg)
    feed = mod.MetricsRegistry()
    raised = []
    t = 0.0
    for i in range(50):
        t += float(rng.exponential(120.0))
        if i % 2:
            mon.ingest(t, "emergency_alarms_total",
                       float(rng.integers(0, 30)))
            mon.ingest(t, "emergency_throttled_seconds_total",
                       float(rng.uniform(0, 40)), level="uf")
            mon.ingest(t, "emergency_throttled_seconds_total",
                       float(rng.uniform(0, 40)), level="nuf")
        else:
            feed.counter("serve_rejects_total", reason="power").inc(
                float(rng.integers(0, 400)))
            feed.counter("emergency_leftover_watts_total").inc(
                float(rng.uniform(0, 900)))
            mon.sample(t, feed)
        raised += mon.evaluate(t)
    return mon, reg, raised


@pytest.mark.parametrize("seed", SEEDS)
def test_slo_monitor_matches(seed):
    got, greg, graised = _fill_slo(P, PS, seed)
    want, wreg, wraised = _fill_slo(R, RS, seed)
    assert _dumps(got.summary()) == _dumps(want.summary())
    assert _dumps(got.active_alerts()) == _dumps(want.active_alerts())
    assert _dumps(graised) == _dumps(wraised)
    assert greg.to_json() == wreg.to_json()


def test_slo_custom_rules_and_refusals_match():
    rules = {m: (m.SLORule("fast", "emergency_alarms_total", budget=5.0,
                           period_s=600.0, windows=((60.0, 2.0),)),)
             for m in (PS, RS)}
    got, _, graised = _fill_slo(P, PS, 7, rules[PS])
    want, _, wraised = _fill_slo(R, RS, 7, rules[RS])
    assert _dumps(got.summary()) == _dumps(want.summary())
    assert _dumps(graised) == _dumps(wraised)
    assert [r.name for r in PS.default_slos()] == \
        [r.name for r in RS.default_slos()]
    for smod in (PS, RS):
        with pytest.raises(ValueError):
            smod.SLORule("bad", "x", budget=0.0)
        with pytest.raises(ValueError):
            smod.SLOMonitor(rules=rules[smod] * 2)


# --- prediction scorecard -------------------------------------------------

def _fill_scorecard(mod, qmod, seed, swap_at=None):
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    card = qmod.PredictionScorecard(registry=reg, reference_n=96,
                                    min_scored=32)
    for k in range(10):
        b = 40
        true_c = rng.integers(0, 2, b)
        true_b = rng.integers(0, 4, b)
        drift = k / 10.0
        raw_c = np.where(rng.random(b) < 0.8 - drift / 2, true_c,
                         1 - true_c)
        raw_b = np.where(rng.random(b) < 0.7, true_b,
                         rng.integers(0, 4, b))
        conf_c, conf_b = rng.random(b), rng.random(b)
        used_c = np.where(conf_c >= 0.6, raw_c, 1)
        used_b = np.where(conf_b >= 0.6, raw_b, 3)
        card.record(true_c, true_b, used_c, used_b, crit_raw=raw_c,
                    crit_conf=conf_c, bucket_raw=raw_b, bucket_conf=conf_b,
                    conservative=(conf_c < 0.6) | (conf_b < 0.6))
        card.observe_alarms(int(rng.integers(0, 3)),
                            cut_w=float(rng.uniform(0, 500)),
                            samples=int(rng.integers(1, 60)))
        card.record(int(true_c[0]), int(true_b[0]), int(used_c[0]),
                    int(used_b[0]))                 # the sim's scalar form
        if k == swap_at:
            card.on_hot_swap()
    return card, reg


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("swap_at", [None, 6])
def test_scorecard_summary_matches(seed, swap_at):
    got, greg = _fill_scorecard(P, PQ, seed, swap_at)
    want, wreg = _fill_scorecard(R, RQ, seed, swap_at)
    assert _dumps(got.summary()) == _dumps(want.summary())
    for head in ("crit", "bucket"):
        assert _dumps(got.offline_style(head)) == \
            _dumps(want.offline_style(head))
    assert got.model_stale == want.model_stale
    assert got.drift() == want.drift()
    assert greg.to_json() == wreg.to_json()


def test_scorecard_reference_and_refusals_match():
    for qmod in (PQ, RQ):
        card = qmod.PredictionScorecard()
        card.set_reference([10, 30], [5, 5, 5, 5], [1, 2, 3, 4])
        card.record(np.ones(80, int), np.zeros(80, int),
                    np.ones(80, int), np.zeros(80, int))
        assert card.model_stale            # everything drifted
        with pytest.raises(ValueError):
            card.set_reference([1, 2, 3], [1] * 4, [1] * 4)
        with pytest.raises(ValueError):
            card.offline_style("both")
        with pytest.raises(ValueError):
            qmod.PredictionScorecard(confidence_gate=1.5)
    got, want = PQ.PredictionScorecard(), RQ.PredictionScorecard()
    for card in (got, want):
        card.set_reference([10, 30], [5, 5, 5, 5], [1, 2, 3, 4])
        card.record(np.ones(80, int), np.zeros(80, int),
                    np.ones(80, int), np.zeros(80, int))
    assert _dumps(got.summary()) == _dumps(want.summary())


# --- flight recorder ------------------------------------------------------

def _fill_recorder(rmod, seed, capacity):
    from repro.serve.ingest import CapBatch as RCap
    from repro.serve.ingest import DepartureBatch as RDep
    from repro_torch.serve.ingest import CapBatch, DepartureBatch
    from repro.sim.telemetry import arrival_batch, generate_population
    cap, dep = (CapBatch, DepartureBatch) if rmod is PR else (RCap, RDep)
    rng = np.random.default_rng(seed)
    rec = rmod.FlightRecorder(capacity_rows=capacity, incident_capacity=3)
    pop = generate_population(40, seed=seed)
    t = 0.0
    for k in range(8):
        rows = np.arange(k * 5, k * 5 + 5)
        stamps = t + np.arange(1, 6, dtype=np.float64)
        rec.record_arrivals(stamps, arrival_batch(pop, rows))
        rec.record_decision(rng.integers(-2, 48, 5), float(stamps[-1]))
        n = int(rng.integers(1, 4))
        rec.record_departures(stamps[-1] + np.arange(1, n + 1) * 0.1, dep(
            rng.integers(0, 48, n).astype(np.int32),
            rng.integers(1, 8, n).astype(np.float32),
            rng.random(n).astype(np.float32), rng.random(n) < 0.5, None))
        rec.record_caps(np.array([stamps[-1] + 0.5]), cap(
            np.array([k % 4], np.int32),
            np.array([rng.uniform(1500, 2300)], np.float32)))
        if k % 3 == 0:
            rec.mark_incident(float(stamps[-1]), k + 1,
                              {"emergency_alarms_total": float(k)})
        t = float(stamps[-1]) + 1.0
    return rec


@pytest.mark.parametrize("capacity", [16, 65536])
def test_recorder_eviction_matches(capacity):
    reference_serve("ingest")
    got = _fill_recorder(PR, 3, capacity)
    want = _fill_recorder(RR, 3, capacity)
    assert _dumps(got.summary()) == _dumps(want.summary())
    np.testing.assert_array_equal(got.decisions(), want.decisions())
    assert [r.seq for r in got.timeline] == [r.seq for r in want.timeline]
    inc_g, inc_w = got.incidents[-1], want.incidents[-1]
    assert [r.seq for r in got.incident_window(inc_g, 5)] == \
        [r.seq for r in want.incident_window(inc_w, 5)]
    assert got.wrapped == want.wrapped == (capacity == 16)


def test_recorder_refuses_a_wrapped_replay():
    reference_serve("ingest")
    got = _fill_recorder(PR, 3, 16)
    want = _fill_recorder(RR, 3, 16)
    for mod, rec in ((PR, got), (RR, want)):
        with pytest.raises(ValueError, match="wrapped"):
            mod.replay(rec, pipeline=None)
        with pytest.raises(ValueError, match="wrapped"):
            mod.verify_replay(rec, pipeline=None)
    with pytest.raises(ValueError):
        PR.FlightRecorder(capacity_rows=0)


# --- tracer and the bundle ------------------------------------------------

def test_tracer_totals_and_ring():
    reg = P.MetricsRegistry()
    tr = P.SpanTracer(reg, capacity=4)
    for _ in range(6):
        with tr.span("place"):
            pass
    with tr.span("infer"):
        pass
    assert len(tr) == 4 and tr.capacity == 4
    totals = tr.totals()
    assert totals["place"][0] == 6 and totals["infer"][0] == 1
    assert list(tr.tail(2)["name"]) == ["place", "infer"]
    assert reg.histogram("serve_span_seconds", span="place").count == 6
    assert tr.tail(2).dtype == R.SpanTracer(R.MetricsRegistry()).tail(0).dtype


def test_torch_profile_writes_a_chrome_trace(tmp_path):
    tr = P.SpanTracer(P.MetricsRegistry())
    with tr.torch_profile(str(tmp_path / "trace"), device="cpu") as prof:
        with tr.span("place"):
            np.arange(10).sum()
    assert prof is not None
    assert tr.last_profile.endswith("profile_0.json")
    trace = json.loads(open(tr.last_profile).read())
    assert "traceEvents" in trace


def test_full_bundle_has_every_pillar():
    got, want = P.Observability.full(), R.Observability.full()
    for f in ("registry", "audit", "tracer", "adaptive", "windows",
              "quality", "slo", "recorder"):
        assert (getattr(got, f) is None) == (getattr(want, f) is None), f
        assert type(getattr(got, f)).__name__ == \
            type(getattr(want, f)).__name__, f
    assert got.windows.registry is got.registry
    assert got.quality.registry is got.registry
    bare = P.Observability()
    with bare.span("place"):
        pass
    assert bare.tracer is None and bare.registry.snapshot() == {}
