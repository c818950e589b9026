"""Declarative SLOs with multi-window burn-rate alerting
(DESIGN.md §17).

An `SLORule` states a budget in the metric's own units over a period
("at most 60 critical throttled-seconds per day"); the `SLOMonitor`
tracks each rule's cumulative consumption on the ingest watermark
clock and computes the *burn rate* over several trailing windows —
``burn = (consumed in window / budget) * (period / window)``, i.e.
1.0 means "spending exactly the budget". An alert fires only when
EVERY window exceeds its threshold (the SRE multi-window pattern: the
short window proves the problem is current, the long window proves it
is material), and clears the same way.

Consumption has two equivalent feeds: `sample(t, registry)` reads the
cumulative counters the pipelines already export (summing a labeled
family when the rule pins no labels), and `ingest(t, metric, delta)`
accepts deltas directly (the simulator path, which must not touch the
registry counters its end-of-run export owns). Alerts and burn rates
are exported back through the registry (``slo_alerts_total{slo=}``,
``slo_burn_rate{slo=,window=}``, ``slo_alert_active{slo=}``) and
rendered by `launch/monitor.py`.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

__all__ = ["SLORule", "SLOMonitor", "default_slos"]

#: (window_seconds, burn-rate threshold) pairs: the canonical fast/slow
#: multi-window pair — 5 minutes at 14.4x (2% of a day's budget in 5
#: minutes) and 1 hour at 6x.
DEFAULT_WINDOWS = ((300.0, 14.4), (3600.0, 6.0))

DAY_S = 86400.0


@dataclass(frozen=True)
class SLORule:
    """One service-level objective: at most ``budget`` units of
    ``metric`` consumed per ``period_s`` seconds.

    ``labels`` restricts which series of a labeled family count
    (``(("level", "uf"),)``); empty means every series of the name is
    summed. ``windows`` is the multi-window burn-rate ladder —
    ``((window_s, threshold), ...)``; ALL windows must exceed their
    threshold to alert."""
    name: str
    metric: str
    budget: float
    period_s: float = DAY_S
    labels: tuple = ()
    windows: tuple = DEFAULT_WINDOWS
    description: str = ""

    def __post_init__(self):
        if not self.budget > 0:
            raise ValueError(
                f"SLO {self.name!r}: budget must be > 0, got "
                f"{self.budget}")
        if not self.period_s > 0:
            raise ValueError(
                f"SLO {self.name!r}: period_s must be > 0, got "
                f"{self.period_s}")
        if not self.windows:
            raise ValueError(f"SLO {self.name!r}: needs >= 1 window")
        for w, thr in self.windows:
            if not (w > 0 and thr > 0):
                raise ValueError(
                    f"SLO {self.name!r}: window/threshold must be > 0, "
                    f"got ({w}, {thr})")


def default_slos() -> tuple:
    """The serve plane's standing objectives (paper-motivated
    defaults; pass custom rules to `SLOMonitor` to replace them)."""
    return (
        SLORule(
            name="critical_throttle",
            metric="emergency_throttled_seconds_total",
            labels=(("level", "uf"),),
            budget=60.0, period_s=DAY_S,
            description="critical (UF) VMs throttled at most 60 "
            "seconds per day — the paper's Table-4 harm axis"),
        SLORule(
            name="watt_overrun",
            metric="emergency_leftover_watts_total",
            budget=1.0e4, period_s=DAY_S,
            description="demanded watts no frequency floor could "
            "absorb (RAPL backstop engaged) stay under 10 kW-sweeps "
            "per day"),
        SLORule(
            name="alarm_rate",
            metric="emergency_alarms_total",
            budget=200.0, period_s=DAY_S,
            description="power-emergency alarms under 200 per day — "
            "above that the oversubscription ratio is mis-set"),
        SLORule(
            name="reject_rate",
            metric="serve_rejects_total",
            budget=1.0e4, period_s=DAY_S,
            description="admission rejections (all reasons) under "
            "10k per day"),
    )


class _RuleState:
    """Per-rule cumulative samples on the watermark clock."""

    def __init__(self, rule: SLORule):
        self.rule = rule
        span = max(w for w, _ in rule.windows)
        self.span = span
        self.samples: deque = deque()    # (t, cumulative) non-decreasing
        self.cum = 0.0
        self.active = False
        self.alerts = 0

    def push(self, t: float, cum: float) -> None:
        self.cum = max(self.cum, cum)
        self.samples.append((t, self.cum))
        # keep one sample at or before t - span so windows always
        # have an anchor; drop everything older than that
        cutoff = t - self.span
        s = self.samples
        while len(s) >= 2 and s[1][0] <= cutoff:
            s.popleft()

    def burn(self, t: float, window: float) -> float:
        """Burn rate over the trailing ``window`` ending at ``t``."""
        if not self.samples:
            return 0.0
        t0 = t - window
        anchor = None
        for ts, cum in self.samples:
            if ts <= t0:
                anchor = cum
            else:
                break
        if anchor is None:
            # stream younger than the window: burn against the span
            # actually observed (never divide by more than asked)
            anchor = self.samples[0][1]
        delta = self.cum - anchor
        r = self.rule
        return (delta / r.budget) * (r.period_s / window)


class SLOMonitor:
    """Evaluates a rule set against the metric stream and raises/
    clears multi-window burn-rate alerts (see module docstring)."""

    def __init__(self, rules=None, registry=None):
        rules = tuple(rules) if rules is not None else default_slos()
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule names: {names}")
        self.rules = rules
        self.registry = registry
        self._state = {r.name: _RuleState(r) for r in rules}
        self.t = -math.inf

    # -- feeds -------------------------------------------------------------
    def ingest(self, t: float, metric: str, delta: float,
               **labels) -> None:
        """Add ``delta`` units of ``metric`` consumption at watermark
        ``t`` (the simulator feed). Labels must cover every label a
        matching rule pins; rules the labels don't match ignore the
        delta."""
        self.t = max(self.t, float(t))
        for st in self._state.values():
            r = st.rule
            if r.metric != metric:
                continue
            if any(labels.get(k) != v for k, v in r.labels):
                continue
            if not st.samples:
                # delta streams start from zero consumption: seed the
                # anchor so the first delta itself counts as burn
                # (sample() deliberately does NOT — counters may hold
                # pre-attach totals that would alert spuriously)
                st.push(self.t, st.cum)
            st.push(self.t, st.cum + float(delta))

    def sample(self, t: float, registry) -> None:
        """Read every rule's cumulative consumption out of the
        registry's counters (the pipeline feed). A rule with pinned
        labels reads that one series; otherwise every series of the
        metric name is summed."""
        self.t = max(self.t, float(t))
        for st in self._state.values():
            r = st.rule
            if r.labels:
                total = registry.value(r.metric, **dict(r.labels))
            else:
                total = 0.0
                for (name, _), m in registry._metrics.items():
                    if name == r.metric:
                        total += float(m.value)
            st.push(self.t, total)

    # -- evaluation --------------------------------------------------------
    def evaluate(self, t: float | None = None) -> list:
        """Evaluate every rule at watermark ``t`` (default: the last
        fed watermark); returns the list of newly raised alert dicts.
        Raising is edge-triggered (``slo_alerts_total`` counts
        transitions); ``slo_alert_active`` tracks the level."""
        if t is not None:
            self.t = max(self.t, float(t))
        raised = []
        for st in self._state.values():
            r = st.rule
            burns = [st.burn(self.t, w) for w, _ in r.windows]
            firing = all(b >= thr for b, (_, thr)
                         in zip(burns, r.windows))
            if self.registry is not None:
                for (w, _), b in zip(r.windows, burns):
                    self.registry.gauge(
                        "slo_burn_rate",
                        help="burn rate (1.0 = spending exactly the "
                        "budget), by SLO and window",
                        slo=r.name, window=f"{w:g}s").set(b)
                self.registry.gauge(
                    "slo_alert_active",
                    help="1 while the SLO's multi-window alert fires",
                    slo=r.name).set(1.0 if firing else 0.0)
            if firing and not st.active:
                st.alerts += 1
                if self.registry is not None:
                    self.registry.counter(
                        "slo_alerts_total",
                        help="multi-window burn-rate alerts raised, "
                        "by SLO", slo=r.name).inc()
                raised.append(self._alert_dict(st, burns))
            st.active = firing
        return raised

    def _alert_dict(self, st: _RuleState, burns) -> dict:
        r = st.rule
        return {"slo": r.name, "t": self.t, "metric": r.metric,
                "burn_rates": {f"{w:g}s": b for (w, _), b
                               in zip(r.windows, burns)},
                "consumed": st.cum, "budget": r.budget,
                "description": r.description}

    def active_alerts(self) -> list:
        """Alert dicts for every rule currently firing."""
        out = []
        for st in self._state.values():
            if st.active:
                burns = [st.burn(self.t, w) for w, _ in st.rule.windows]
                out.append(self._alert_dict(st, burns))
        return out

    def summary(self) -> dict:
        """JSON-ready per-rule view (burn rates, consumption, alert
        state) for the monitor."""
        out = {}
        for st in self._state.values():
            r = st.rule
            out[r.name] = {
                "metric": r.metric, "labels": dict(r.labels),
                "budget": r.budget, "period_s": r.period_s,
                "consumed": st.cum,
                "burn_rates": {f"{w:g}s": st.burn(self.t, w)
                               for w, _ in r.windows},
                "active": st.active, "alerts": st.alerts,
                "description": r.description}
        return out
