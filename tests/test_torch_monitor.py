"""The scheduler simulation with the observability plane and the port's
monitor CLI (`repro_torch.launch.monitor`), on the CPU.

- `simulate(..., obs=)` gives the trace and every `SimMetrics` field of
  the run without it, on the event, serve and serve-sharded backends.
- `record_sim_metrics` exports what the reference's does.
- The monitor's ``--sim`` run gives the reference's ``--sim`` run's
  registry snapshot (spans by name and count), SLO, scorecard, window
  and recorder sections, and Prometheus text; `main` round-trips its
  snapshot, Prometheus text and alerts through argv.

The reference's own monitor tests fail on the installed jax (its serve
backend calls the removed `jax.experimental.enable_x64`), so the targets
here come from the reference run through `_torch_parity`.
"""
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from _torch_parity import reference_enable_x64, reference_serve  # noqa
from repro import obs as R  # noqa: E402
from repro_torch import obs as P  # noqa: E402
from repro_torch.core.placement import SchedulerPolicy  # noqa: E402
from repro_torch.core.resources import ResourceVector  # noqa: E402
from repro_torch.launch import monitor  # noqa: E402
from repro_torch.serve import AdaptiveConfig, EmergencyConfig  # noqa: E402
from repro_torch.sim import scheduler_sim as S  # noqa: E402

SIM = dict(shards=2, days=0.1, seed=4)


@pytest.fixture(scope="module")
def sims():
    """The monitor's --sim run, the port's on the CPU and the
    reference's, on one seed."""
    from repro.launch import monitor as rmonitor
    reference_serve()
    with pytest.MonkeyPatch.context() as mp:
        reference_enable_x64(mp)
        want = rmonitor._run_sim(**SIM)
    return monitor._run_sim(device="cpu", **SIM), want


def _no_spans(snap: dict) -> dict:
    return {k: v for k, v in snap.items() if k != "serve_span_seconds"}


def test_sim_snapshot_matches_reference(sims):
    got, want = sims
    gs, ws = got.registry.snapshot(), want.registry.snapshot()
    assert _no_spans(gs) == _no_spans(ws)
    assert [(s["labels"], s["count"]) for s in gs["serve_span_seconds"]] \
        == [(s["labels"], s["count"]) for s in ws["serve_span_seconds"]]
    assert gs["sim_placements_total"][0]["value"] > 0
    assert gs["emergency_alarms_total"][0]["value"] > 0


@pytest.mark.parametrize("section", ["slo", "quality", "windows",
                                     "incidents", "audit"])
def test_snapshot_sections_match_reference(sims, section):
    got, want = (monitor.snapshot_dict(o) for o in sims)
    assert set(got) == set(want)
    assert json.dumps(got[section], sort_keys=True) == \
        json.dumps(want[section], sort_keys=True)
    assert {k: v["count"] for k, v in got["spans"].items()} == \
        {k: v["count"] for k, v in want["spans"].items()}


def test_prometheus_text_matches_reference(sims):
    got, want = (o.registry.to_prometheus().splitlines() for o in sims)

    def timed(line):
        return "serve_span_seconds" in line
    assert [ln for ln in got if not timed(ln)] == \
        [ln for ln in want if not timed(ln)]
    text = "\n".join(got)
    for family in ("# TYPE sim_placements_total counter", "slo_burn_rate",
                   "quality_scored", "emergency_throttled_seconds_total",
                   'serve_dispatch_total{kind="sharded_round"}'):
        assert family in text


def test_report_has_all_pillar_sections(sims):
    out = monitor.render_report(sims[0])
    for section in ("== metrics ==", "== spans ==", "== slo ==",
                    "== quality =="):
        assert section in out
    assert "critical_throttle" in out
    assert "scored=" in out and "drift" in out and "burn[" in out


def test_snapshot_round_trips_with_full_schema(sims, tmp_path):
    p = str(tmp_path / "obs_snapshot.json")
    monitor.write_snapshot(sims[0], p)
    with open(p) as f:
        snap = json.load(f)
    assert set(snap) == {"metrics", "spans", "audit", "slo", "quality",
                         "windows", "incidents"}
    assert snap == json.loads(json.dumps(monitor.snapshot_dict(sims[0])))
    q = snap["quality"]
    assert q["n_scored"] > 0
    assert np.isclose(q["crit_accuracy"], np.trace(q["crit_confusion"])
                      / np.sum(q["crit_confusion"]))
    assert snap["windows"]["watermark"] > 0
    assert snap["incidents"]["capacity_rows"] > 0


def test_alerts_artifact_matches_reference(sims, tmp_path):
    paths = [str(tmp_path / f"alerts_{i}.json") for i in range(2)]
    monitor.write_alerts(sims[0], paths[0])
    from repro.launch import monitor as rmonitor
    rmonitor.write_alerts(sims[1], paths[1])
    got, want = (json.load(open(p)) for p in paths)
    assert got == want
    assert set(got) == {"active", "rules"}
    for a in got["active"]:
        assert got["rules"][a["slo"]]["active"] is True


def test_main_cli_round_trip(tmp_path, capsys):
    out_p = str(tmp_path / "snap.json")
    prom_p = str(tmp_path / "metrics.prom")
    alerts_p = str(tmp_path / "alerts.json")
    obs = monitor.main(["--sim", "--device", "cpu", "--shards", "2",
                        "--days", "0.05", "--seed", "0", "--out", out_p,
                        "--prom", prom_p, "--alerts", alerts_p])
    out = capsys.readouterr().out
    assert "== metrics ==" in out and "== slo ==" in out
    for p in (out_p, prom_p, alerts_p):
        assert f"-> {p}" in out
    with open(out_p) as f:
        snap = json.load(f)
    assert snap["metrics"] == json.loads(json.dumps(
        obs.registry.snapshot()))
    with open(alerts_p) as f:
        assert set(json.load(f)) == {"active", "rules"}
    with open(prom_p) as f:
        assert f.read() == obs.registry.to_prometheus()


def test_main_without_sim_fails_fast(capsys):
    with pytest.raises(SystemExit):
        monitor.main(["--out", "x.json"])
    assert "--sim" in capsys.readouterr().err


def test_write_alerts_on_bare_bundle(tmp_path):
    p = str(tmp_path / "alerts.json")
    monitor.write_alerts(P.Observability(), p)
    with open(p) as f:
        assert json.load(f) == {"active": [], "rules": {}}


# --- the simulation with obs ----------------------------------------------

def _assert_metrics_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("backend", ["event", "serve", "serve-sharded"])
def test_simulate_with_obs_is_decision_neutral(backend):
    serve = dict(backend=backend)
    if backend == "serve-sharded":
        serve.update(shards=4, cluster_budget=ResourceVector(watts=2.0e6))
    spec = S.SimSpec(days=0.05, seed=4, prefill_core_ratio=0.5,
                     serve=S.ServeBackendSpec(**serve),
                     emergency=EmergencyConfig.from_model(1480.0),
                     adaptive=None if backend == "event"
                     else AdaptiveConfig())
    obs = P.Observability.full()
    tr_on, tr_off = [], []
    pol, ch = SchedulerPolicy(), S.PredictionChannel()
    on = S.simulate(pol, ch, spec, trace=tr_on, obs=obs, device="cpu")
    off = S.simulate(pol, ch, spec, trace=tr_off, device="cpu")
    assert tr_on == tr_off
    _assert_metrics_equal(on, off)
    v = obs.registry.value
    assert v("sim_placements_total") == on.placements
    assert v("emergency_alarms_total") == on.alarms
    for i, level in enumerate(P.LEVEL_NAMES):
        assert v("emergency_throttled_seconds_total", level=level) == \
            on.throttled_s[i]
    assert obs.quality.n_scored == on.crit_confusion.sum()
    assert obs.slo.summary()["alarm_rate"]["consumed"] == on.alarms
    spans = set(obs.tracer.totals())
    assert "emergency" in spans
    if backend != "event":
        assert {"place", "adaptive"} <= spans
        kind = "place_batch" if backend == "serve" else "sharded_round"
        assert v("serve_dispatch_total", kind=kind) > 0


@pytest.mark.parametrize("scored", [False, True])
def test_record_sim_metrics_matches_reference(scored):
    from repro.sim.scheduler_sim import SimMetrics as RMetrics
    kw = dict(failure_rate=0.25, empty_server_ratio=0.5,
              chassis_score_std=0.1, server_score_std=0.2, placements=8,
              failures=2, throttled_s=np.array([30.0, 5.0]), alarms=3,
              migrations=1, adaptive_ratio=1.15, adaptive_ratchets=4,
              adaptive_backoffs=1)
    if scored:
        kw.update(crit_confusion=np.array([[5, 1], [0, 2]]),
                  p95_confusion=np.diag([2, 2, 2, 2]))
    got, want = P.MetricsRegistry(), R.MetricsRegistry()
    P.record_sim_metrics(got, S.SimMetrics(**kw))
    R.record_sim_metrics(want, RMetrics(**kw))
    assert got.to_json() == want.to_json()
    assert got.to_prometheus() == want.to_prometheus()
    assert (got.value("sim_pred_scored_total") > 0) == scored
