"""Observability snapshot reporting, the torch port's copy of
`repro.launch.monitor` (DESIGN.md §14, §17).

Renders one `repro_torch.obs.Observability` bundle as a human report —
the metric catalog with current values, per-stage span timings, SLO
burn-rate states with any active alerts, the prediction-quality
scorecard, flight-recorder incidents, and the most recent audit-trail
decisions — and writes the machine-readable snapshot (registry JSON +
span totals + audit tail + slo/quality/windows/incidents sections).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.monitor --sim --shards 4 \
      --days 0.25 --out obs_snapshot.json --alerts obs_alerts.json

``--sim`` runs a short metrics-enabled sharded simulation
(`sim.scheduler_sim.simulate` on its serve-sharded backend with the
power-emergency plane on) on ``--device`` (the card by default;
``--device cpu`` runs it on the host), so a snapshot can be produced
without live traffic; the report/snapshot functions work on any bundle
a serving process filled.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.obs import AuditRecord, Observability

__all__ = ["render_report", "snapshot_dict", "write_snapshot",
           "write_alerts", "main"]


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render_report(obs: Observability, audit_tail: int = 8) -> str:
    """One multi-section text report of the whole bundle: every
    counter/gauge with its current value, histogram quantiles, span
    totals from the tracer, per-rule SLO burn rates (active alerts
    flagged), the prediction scorecard, flight-recorder incidents,
    and the trailing audit decisions (`AuditRecord.describe` lines).
    Sections for pillars that are off are omitted."""
    lines = ["== metrics =="]
    for (name, labels), m in sorted(obs.registry._metrics.items()):
        label = _fmt_labels(dict(labels))
        if m.kind == "histogram":
            lines.append(
                f"  {name}{label}  count={m.count} sum={m.sum:.6g} "
                f"p50={m.quantile(0.5):.3g} "
                f"p99={m.quantile(0.99):.3g}")
        else:
            lines.append(f"  {name}{label}  {m.value:.6g}")
    if obs.tracer is not None and len(obs.tracer):
        lines.append("== spans ==")
        for span, (count, total) in sorted(obs.tracer.totals().items()):
            mean_ms = 1e3 * total / max(count, 1)
            lines.append(f"  {span:<12} n={count:<8.0f} "
                         f"total={total:.3f}s mean={mean_ms:.2f}ms")
    if obs.slo is not None:
        lines.append("== slo ==")
        for name, s in sorted(obs.slo.summary().items()):
            burns = " ".join(f"{w}:{b:.3g}x"
                             for w, b in s["burn_rates"].items())
            flag = "  ** ALERT **" if s["active"] else ""
            lines.append(
                f"  {name:<18} consumed={s['consumed']:.6g}"
                f"/{s['budget']:.6g} burn[{burns}] "
                f"alerts={s['alerts']}{flag}")
    if obs.quality is not None and obs.quality.n_scored:
        q = obs.quality.summary()
        lines.append("== quality ==")
        lines.append(
            f"  scored={q['n_scored']} "
            f"crit_acc={_num(q['crit_accuracy'])} "
            f"p95_acc={_num(q['p95_accuracy'])} "
            f"stale={q['model_stale']}")
        lines.append(
            f"  drift " + " ".join(f"{c}={v:.3g}"
                                   for c, v in q["drift"].items())
            + f" throttle_rate={q['throttle_rate']:.3g}")
    if obs.recorder is not None and obs.recorder.incidents:
        lines.append(f"== incidents (last "
                     f"{len(obs.recorder.incidents)}) ==")
        for inc in obs.recorder.incidents:
            lines.append(f"  t={inc.t:.6g} alarms={inc.alarms} "
                         f"seq={inc.seq}")
    if obs.audit is not None and len(obs.audit):
        lines.append(f"== audit (last {audit_tail} of "
                     f"{obs.audit.total_recorded}) ==")
        rows = obs.audit.tail(audit_tail)
        lines.extend("  " + AuditRecord(r).describe() for r in rows)
        rej = obs.audit.rejected(audit_tail)
        if rej:
            lines.append("== audit: recent rejections ==")
            lines.extend("  " + r.describe() for r in rej)
    return "\n".join(lines)


def _num(x) -> str:
    """Format a maybe-None scorecard number."""
    return "n/a" if x is None else f"{x:.4g}"


def snapshot_dict(obs: Observability, audit_tail: int = 64) -> dict:
    """JSON-serializable snapshot of the bundle: the full registry
    snapshot plus span totals, the audit tail (decoded to plain Python
    scalars), and — for pillars that are on — the SLO rule states,
    the quality scorecard, the windowed aggregates, and the flight
    recorder's occupancy/incidents: the artifact schema of
    `write_snapshot`."""
    out = {"metrics": obs.registry.snapshot()}
    if obs.tracer is not None:
        out["spans"] = {k: {"count": int(c), "total_s": float(s)}
                        for k, (c, s) in obs.tracer.totals().items()}
    if obs.audit is not None:
        rows = obs.audit.tail(audit_tail)
        out["audit"] = {
            "total_recorded": obs.audit.total_recorded,
            "tail": [{k: r[k].item() for k in rows.dtype.names}
                     for r in rows],
        }
    if obs.slo is not None:
        out["slo"] = {"rules": obs.slo.summary(),
                      "active_alerts": obs.slo.active_alerts()}
    if obs.quality is not None:
        out["quality"] = obs.quality.summary()
    if obs.windows is not None:
        out["windows"] = obs.windows.summary()
    if obs.recorder is not None:
        out["incidents"] = obs.recorder.summary()
    return out


def write_snapshot(obs: Observability, path: str,
                   audit_tail: int = 64) -> None:
    """Write `snapshot_dict` to `path` as indented JSON."""
    with open(path, "w") as f:
        json.dump(snapshot_dict(obs, audit_tail), f, indent=2)
        f.write("\n")


def write_alerts(obs: Observability, path: str) -> None:
    """Write the SLO monitor's active alerts (plus per-rule burn
    states) to `path` as indented JSON — the pageable artifact. An
    empty ``active`` list is the good case."""
    alerts = {"active": [], "rules": {}}
    if obs.slo is not None:
        alerts["active"] = obs.slo.active_alerts()
        alerts["rules"] = obs.slo.summary()
    with open(path, "w") as f:
        json.dump(alerts, f, indent=2)
        f.write("\n")


def _run_sim(shards: int, days: float, seed: int,
             device=None) -> Observability:
    """Drive a short metrics-enabled sharded sim (emergency plane on,
    warm-started near the alarm threshold) on `device` (None: the card)
    and return its bundle."""
    from repro_torch.core.placement import SchedulerPolicy
    from repro_torch.core.resources import ResourceVector
    from repro_torch.serve.emergency import EmergencyConfig
    from repro_torch.sim.scheduler_sim import (PredictionChannel,
                                               ServeBackendSpec, SimSpec,
                                               simulate)

    obs = Observability.full()
    simulate(SchedulerPolicy(), PredictionChannel(),
             SimSpec(days=days, seed=seed, prefill_core_ratio=0.5,
                     serve=ServeBackendSpec(
                         backend="serve-sharded", shards=shards,
                         cluster_budget=ResourceVector(watts=2.0e6)),
                     emergency=EmergencyConfig.from_model(1480.0)),
             obs=obs, device=device)
    return obs


def main(argv=None) -> Observability:
    """CLI: run the ``--sim`` simulation (or fail fast without it — there
    is no live bundle to read from a fresh process), print the report,
    and optionally write the JSON snapshot / Prometheus text / active
    SLO alerts. Returns the bundle."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sim", action="store_true",
                    help="drive a short metrics-enabled sharded sim")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--days", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the sim's serve backend places (default "
                    "the card; 'cpu' runs it on the host)")
    ap.add_argument("--out", default=None,
                    help="write the JSON snapshot here")
    ap.add_argument("--prom", default=None,
                    help="write Prometheus exposition text here")
    ap.add_argument("--alerts", default=None,
                    help="write active SLO alerts (JSON) here")
    args = ap.parse_args(argv)
    if not args.sim:
        ap.error("--sim is the only source of a bundle here (a serving "
                 "process renders its own via render_report)")
    obs = _run_sim(args.shards, args.days, args.seed, args.device)
    print(render_report(obs))
    if args.out:
        write_snapshot(obs, args.out)
        print(f"[monitor] snapshot -> {args.out}")
    if args.prom:
        with open(args.prom, "w") as f:
            f.write(obs.registry.to_prometheus())
        print(f"[monitor] prometheus -> {args.prom}")
    if args.alerts:
        write_alerts(obs, args.alerts)
        print(f"[monitor] alerts -> {args.alerts}")
    return obs


if __name__ == "__main__":
    main()
