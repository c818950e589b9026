"""Host-side metrics registry (DESIGN.md §14, docs/observability.md).

The serve plane's device steps return small counter tuples
(`serve.placement.SweepCounters`, the per-call ``info`` of
`serve.sharding.place_group_sharded`); this module is where those
scalars — and the host-side stream/sim counters that ride along —
accumulate into something an operator can scrape. Three metric kinds,
mirroring the Prometheus data model the exporters speak:

  * **Counter** — monotone float accumulator (`inc`); negative
    increments are rejected so a scrape can always be rate()d.
  * **Gauge** — last-write-wins level (`set`), e.g. remaining
    power-pool tokens.
  * **Histogram** — log-bucketed distribution (`observe`): bucket
    upper bounds grow geometrically from `lo` by `base`, so the whole
    span from microseconds to minutes (or watts to megawatts) costs a
    few dozen integer cells, exactly the classic HDR/Prometheus trick.

Metrics are identified by name plus an optional frozen label set
(``registry.counter("serve_rejects_total", reason="capacity")``), one
time series per distinct label value — the same convention both
exporters render. Everything is plain Python + numpy on the host: the
registry never holds a tensor and never feeds a device call, and
therefore can never perturb a placement decision (the bit-identity
tests assert exactly that).

Snapshots come in two formats: `MetricsRegistry.snapshot` (a plain
JSON-able dict, the artifact `launch.monitor` writes) and
`MetricsRegistry.to_prometheus` (the text exposition format, so a
scrape endpoint is one ``http.server`` handler away).
"""
from __future__ import annotations

import json
import math

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LEVEL_NAMES"]

#: Canonical criticality-level label values, in the emergency plane's
#: apportionment priority order (`serve.emergency.CRIT_NUF` = 0 first)
#: — the one spelling both the sim and serve exporters use, fixing the
#: historical `uf_throttled_s` vs per-level-array naming drift.
LEVEL_NAMES = ("nuf", "uf")


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Monotone accumulator. `inc` rejects negative deltas — a counter
    that can go down cannot be rate()d, use a `Gauge` for levels."""

    kind = "counter"

    def __init__(self, name: str, labels: tuple, help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        """Add `v` (>= 0) to the counter."""
        v = float(v)
        if not v >= 0.0:        # also catches NaN
            raise ValueError(
                f"counter {self.name} increment must be >= 0, got {v}")
        self.value += v

    def _sample(self):
        return {"value": self.value}

    def _expose(self) -> list:
        return [f"{self.name}{_render_labels(self.labels)} "
                f"{self.value:g}"]


class Gauge:
    """Last-write-wins level (`set`), with `inc`/`dec` conveniences."""

    kind = "gauge"

    def __init__(self, name: str, labels: tuple, help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        """Set the gauge to `v`."""
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        """Add `v` (may be negative) to the gauge."""
        self.value += float(v)

    def dec(self, v: float = 1.0) -> None:
        """Subtract `v` from the gauge."""
        self.value -= float(v)

    def _sample(self):
        return {"value": self.value}

    def _expose(self) -> list:
        return [f"{self.name}{_render_labels(self.labels)} "
                f"{self.value:g}"]


class Histogram:
    """Log-bucketed distribution.

    Bucket upper bounds are ``lo * base**k`` for ``k = 0..n_buckets-1``
    plus a +inf overflow bucket; an observation lands in the first
    bucket whose bound is >= the value (values <= `lo` land in bucket
    0, so `lo` is the resolution floor, not a clamp of the recorded
    `sum`). With the defaults (lo=1e-6, base=2, 64 buckets) one
    histogram spans microseconds to ~2.5 weeks at 2x resolution for
    128 integer cells — the reason the serve path can afford a
    histogram per span kind."""

    kind = "histogram"

    def __init__(self, name: str, labels: tuple, help: str = "",
                 lo: float = 1e-6, base: float = 2.0,
                 n_buckets: int = 64):
        if not (lo > 0 and base > 1):
            raise ValueError("need lo > 0 and base > 1")
        self.name = name
        self.labels = labels
        self.help = help
        self.lo = float(lo)
        self.base = float(base)
        self.bounds = lo * np.power(base, np.arange(n_buckets))
        self.counts = np.zeros(n_buckets + 1, np.int64)  # [+inf overflow]
        self.sum = 0.0
        self.count = 0

    def _bucket(self, v: float) -> int:
        if v <= self.lo:
            return 0
        k = math.ceil(math.log(v / self.lo) / math.log(self.base))
        return min(max(k, 0), len(self.bounds))

    def observe(self, v: float) -> None:
        """Record one observation (negative values clamp to bucket 0;
        the exact value still lands in `sum`)."""
        v = float(v)
        self.counts[self._bucket(v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Approximate q-quantile: the upper bound of the bucket where
        the cumulative count crosses ``q * count`` (NaN when empty).
        Log bucketing bounds the relative error by `base`."""
        if not self.count:
            return float("nan")
        target = q * self.count
        cum = np.cumsum(self.counts)
        k = int(np.searchsorted(cum, target))
        return float(self.bounds[min(k, len(self.bounds) - 1)])

    def _sample(self):
        nz = np.nonzero(self.counts)[0]
        return {"sum": self.sum, "count": self.count,
                "buckets": {
                    ("+inf" if k == len(self.bounds)
                     else f"{self.bounds[k]:.6g}"): int(self.counts[k])
                    for k in nz}}

    def _expose(self) -> list:
        lab = dict(self.labels)
        lines, cum = [], 0
        for k, c in enumerate(self.counts):
            if not c:
                continue
            cum_k = int(self.counts[:k + 1].sum())
            le = "+Inf" if k == len(self.bounds) \
                else f"{self.bounds[k]:.6g}"
            key = _label_key({**lab, "le": le})
            lines.append(f"{self.name}_bucket{_render_labels(key)} "
                         f"{cum_k}")
            cum = cum_k
        if cum != self.count:       # render a closing +Inf bucket
            key = _label_key({**lab, "le": "+Inf"})
            lines.append(f"{self.name}_bucket{_render_labels(key)} "
                         f"{self.count}")
        lines.append(f"{self.name}_sum{_render_labels(self.labels)} "
                     f"{self.sum:g}")
        lines.append(f"{self.name}_count{_render_labels(self.labels)} "
                     f"{self.count}")
        return lines


class MetricsRegistry:
    """Flat namespace of counters/gauges/histograms, one time series
    per (name, label set). Accessors are get-or-create and idempotent,
    so instrumented code never has to pre-declare its metrics; asking
    for an existing name with a different metric kind is an error (the
    exporters could not render it coherently)."""

    def __init__(self):
        self._metrics: dict = {}    # (name, labelkey) -> metric
        self._help: dict = {}       # name -> help string

    def _get(self, cls, name: str, help: str, labels: dict, **kw):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[1], help=help or self._help.get(name, ""),
                    **kw)
            self._metrics[key] = m
            if help:
                self._help.setdefault(name, help)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        """Get-or-create the counter `name` with the given labels."""
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        """Get-or-create the gauge `name` with the given labels."""
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", lo: float = 1e-6,
                  base: float = 2.0, n_buckets: int = 64,
                  **labels) -> Histogram:
        """Get-or-create the log-bucketed histogram `name`; `lo`/
        `base`/`n_buckets` set the bucket geometry on first creation
        (ignored on later lookups)."""
        return self._get(Histogram, name, help, labels, lo=lo,
                         base=base, n_buckets=n_buckets)

    def value(self, name: str, **labels) -> float:
        """Current value of a counter/gauge (0.0 when the series does
        not exist — absent and never-incremented read the same, like a
        Prometheus scrape)."""
        m = self._metrics.get((name, _label_key(labels)))
        return 0.0 if m is None else m.value

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able dict of every series: ``name -> [{labels, kind,
        ...samples}]`` — the artifact format `launch.monitor`
        writes."""
        out: dict = {}
        for (name, labels), m in sorted(self._metrics.items()):
            out.setdefault(name, []).append(
                {"labels": dict(labels), "kind": m.kind, **m._sample()})
        return out

    def to_json(self, indent: int | None = 2) -> str:
        """`snapshot` as a JSON string."""
        return json.dumps(self.snapshot(), indent=indent)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one ``# TYPE`` header per
        metric name, histogram bucket series cumulative)."""
        by_name: dict = {}
        for (name, _), m in sorted(self._metrics.items()):
            by_name.setdefault(name, []).append(m)
        lines = []
        for name, series in by_name.items():
            help_ = self._help.get(name, "")
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {series[0].kind}")
            for m in series:
                lines.extend(m._expose())
        return "\n".join(lines) + "\n"
