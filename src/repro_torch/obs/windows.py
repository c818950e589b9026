"""Watermark-aligned windowed aggregation (DESIGN.md §17).

Counters answer "how much, ever"; operations needs "how much,
*lately*". This module adds the time dimension to the obs plane with
three primitives, all host-side and all fed exclusively by values the
device steps already return as *outputs* (never inputs — decisions
stay bit-identical with the plane on or off):

  * `FixedHistogram` — streaming fixed-bucket histogram with explicit
    bounds (the registry's log-bucketed histograms cover magnitudes;
    SLO math wants linear buckets over a known range).
  * `TumblingWindow` — non-overlapping buckets aligned to multiples of
    the window width on the *ingest watermark clock* (the merged-stream
    event stamps, not wall time), closed only when the watermark
    passes their end — late events past the watermark are counted,
    never silently folded into a closed window.
  * `RollingWindow` — trailing-width sliding aggregate (sum / rate /
    mean) over the same clock, the burn-rate primitive `obs.slo`
    builds on.

`WindowPlane` bundles named signals of all three behind one
`observe`/`advance` pair and mirrors the trailing aggregates into the
metrics registry as `obs_window_sum{signal=}` /
`obs_window_rate_per_s{signal=}` gauges, so windowed views ride the
same Prometheus/JSON export as everything else.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

__all__ = ["FixedHistogram", "WindowAgg", "TumblingWindow",
           "RollingWindow", "WindowPlane"]


class FixedHistogram:
    """Streaming histogram over ``n_bins`` equal-width buckets spanning
    ``[lo, hi)``, with explicit underflow/overflow counts. O(1) per
    observation, O(n_bins) memory, and a quantile read that never
    needs the raw samples back."""

    def __init__(self, lo: float, hi: float, n_bins: int = 32):
        if not (hi > lo):
            raise ValueError(f"need hi > lo, got [{lo}, {hi})")
        if n_bins < 1:
            raise ValueError(f"n_bins must be >= 1, got {n_bins}")
        self.lo, self.hi, self.n_bins = float(lo), float(hi), int(n_bins)
        self._width = (self.hi - self.lo) / self.n_bins
        self.counts = [0] * self.n_bins
        self.underflow = 0
        self.overflow = 0
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float, n: int = 1) -> None:
        """Fold ``n`` occurrences of ``value`` in (NaN is counted as
        overflow — a poisoned stat should be visible, not dropped)."""
        v = float(value)
        self.total += n
        if math.isnan(v) or v >= self.hi:
            self.overflow += n
            self.sum += 0.0 if math.isnan(v) else v * n
            return
        self.sum += v * n
        if v < self.lo:
            self.underflow += n
            return
        self.counts[int((v - self.lo) / self._width)] += n

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (bucket upper edge; ``lo``/``hi``
        for mass in the under/overflow buckets). NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.total == 0:
            return float("nan")
        rank = q * self.total
        seen = self.underflow
        if rank <= seen and self.underflow:
            return self.lo
        for i, c in enumerate(self.counts):
            seen += c
            if rank <= seen and c:
                return self.lo + (i + 1) * self._width
        return self.hi

    @property
    def mean(self) -> float:
        """Mean of everything observed (NaN when empty)."""
        return self.sum / self.total if self.total else float("nan")

    def snapshot(self) -> dict:
        """JSON-ready view: bounds, counts, and p50/p99 reads."""
        return {"lo": self.lo, "hi": self.hi, "counts": list(self.counts),
                "underflow": self.underflow, "overflow": self.overflow,
                "total": self.total, "sum": self.sum,
                "p50": self.quantile(0.5), "p99": self.quantile(0.99)}


@dataclass
class WindowAgg:
    """One window's aggregate: [t0, t1) bounds, count/sum/min/max."""
    t0: float
    t1: float
    count: int = 0
    sum: float = 0.0
    vmin: float = math.inf
    vmax: float = -math.inf

    def observe(self, v: float, n: int = 1) -> None:
        """Fold ``n`` occurrences of ``v`` into the aggregate."""
        self.count += n
        self.sum += v * n
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    @property
    def mean(self) -> float:
        """Mean value in the window (NaN when empty)."""
        return self.sum / self.count if self.count else float("nan")

    def as_dict(self) -> dict:
        """JSON-ready view of the aggregate."""
        return {"t0": self.t0, "t1": self.t1, "count": self.count,
                "sum": self.sum, "min": self.vmin, "max": self.vmax}


class TumblingWindow:
    """Non-overlapping aggregation buckets aligned to multiples of
    ``width`` on the watermark clock.

    ``observe(t, v)`` lands in the bucket ``floor(t / width)``;
    ``advance(watermark)`` closes every open bucket whose end is at or
    before the watermark into a bounded history (newest-last,
    ``keep`` deep). Events stamped before the watermark's closed
    frontier bump ``late`` instead of mutating closed windows — the
    merge already promises watermark order, so a late event here is a
    contract violation worth counting, not hiding."""

    def __init__(self, width: float, keep: int = 64):
        if not width > 0:
            raise ValueError(f"width must be > 0, got {width}")
        self.width = float(width)
        self.keep = int(keep)
        self._open: dict = {}            # bucket index -> WindowAgg
        self.closed: deque = deque(maxlen=keep)
        self.watermark = -math.inf
        self.late = 0

    def observe(self, t: float, v: float = 1.0, n: int = 1) -> None:
        """Fold ``n`` occurrences of ``v`` stamped ``t`` in."""
        idx = math.floor(t / self.width)
        if (idx + 1) * self.width <= self.watermark:
            self.late += n
            return
        agg = self._open.get(idx)
        if agg is None:
            agg = self._open[idx] = WindowAgg(
                idx * self.width, (idx + 1) * self.width)
        agg.observe(v, n)

    def advance(self, watermark: float) -> list:
        """Move the watermark forward, closing (and returning) every
        bucket whose end it passed. The watermark never moves back."""
        self.watermark = max(self.watermark, float(watermark))
        done = sorted(i for i in self._open
                      if (i + 1) * self.width <= self.watermark)
        out = [self._open.pop(i) for i in done]
        self.closed.extend(out)
        return out

    @property
    def last(self) -> WindowAgg | None:
        """Most recently closed window (None before the first close)."""
        return self.closed[-1] if self.closed else None


class RollingWindow:
    """Sliding trailing-``width`` aggregate over (t, value) samples:
    O(1) amortized observe, exact trailing sum/count, and a per-second
    rate — the multi-window burn-rate primitive."""

    def __init__(self, width: float):
        if not width > 0:
            raise ValueError(f"width must be > 0, got {width}")
        self.width = float(width)
        self._q: deque = deque()        # (t, v) in stamp order
        self._sum = 0.0
        self.t = -math.inf

    def observe(self, t: float, v: float = 1.0) -> None:
        """Fold one sample in and evict everything older than
        ``t - width``."""
        self._q.append((float(t), float(v)))
        self._sum += float(v)
        self.advance(t)

    def advance(self, t: float) -> None:
        """Move the clock forward (evicting expired samples) without
        adding a sample."""
        self.t = max(self.t, float(t))
        cutoff = self.t - self.width
        q = self._q
        while q and q[0][0] <= cutoff:
            self._sum -= q.popleft()[1]

    @property
    def sum(self) -> float:
        """Sum of values in the trailing window."""
        return self._sum

    @property
    def count(self) -> int:
        """Number of samples in the trailing window."""
        return len(self._q)

    @property
    def rate(self) -> float:
        """Trailing per-second rate (``sum / width``)."""
        return self._sum / self.width


class WindowPlane:
    """Named-signal front door over the window primitives.

    ``observe(t, name, v)`` lazily creates one tumbling + one rolling
    window per signal and feeds both; ``advance(watermark)`` closes
    tumbling buckets everywhere and mirrors each signal's trailing
    aggregates into the registry (``obs_window_sum{signal=}`` /
    ``obs_window_rate_per_s{signal=}`` gauges).
    ``observe_hist(name, v, ...)`` maintains fixed-bucket value
    histograms beside the time windows."""

    def __init__(self, registry=None, width: float = 60.0,
                 rolling: float = 300.0, keep: int = 64):
        if not (width > 0 and rolling > 0):
            raise ValueError(
                f"width and rolling must be > 0, got {width}, {rolling}")
        self.registry = registry
        self.width = float(width)
        self.rolling = float(rolling)
        self.keep = int(keep)
        self.signals: dict = {}          # name -> (Tumbling, Rolling)
        self.hists: dict = {}            # name -> FixedHistogram
        self.watermark = -math.inf

    def _signal(self, name: str):
        pair = self.signals.get(name)
        if pair is None:
            pair = self.signals[name] = (
                TumblingWindow(self.width, self.keep),
                RollingWindow(self.rolling))
        return pair

    def observe(self, t: float, name: str, v: float = 1.0,
                n: int = 1) -> None:
        """Fold ``n`` occurrences of ``v`` stamped ``t`` into signal
        ``name`` (created lazily on first use)."""
        tum, rol = self._signal(name)
        tum.observe(t, v, n)
        for _ in range(n):
            rol.observe(t, v)

    def observe_hist(self, name: str, value: float, lo: float = 0.0,
                     hi: float = 1.0, n_bins: int = 32) -> None:
        """Fold ``value`` into the fixed-bucket histogram ``name``
        (bounds fix at first call; later bounds are ignored)."""
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = FixedHistogram(lo, hi, n_bins)
        h.observe(value)

    def advance(self, watermark: float) -> None:
        """Advance every signal to the new watermark and export the
        trailing aggregates as registry gauges."""
        self.watermark = max(self.watermark, float(watermark))
        for name, (tum, rol) in self.signals.items():
            tum.advance(self.watermark)
            rol.advance(self.watermark)
            if self.registry is not None:
                self.registry.gauge(
                    "obs_window_sum",
                    help="trailing-window sum, by signal",
                    signal=name).set(rol.sum)
                self.registry.gauge(
                    "obs_window_rate_per_s",
                    help="trailing-window per-second rate, by signal",
                    signal=name).set(rol.rate)

    def summary(self) -> dict:
        """JSON-ready view: per-signal trailing aggregates, last
        closed tumbling window, late counts, and histograms."""
        out: dict = {"watermark": self.watermark, "signals": {},
                     "histograms": {}}
        for name, (tum, rol) in sorted(self.signals.items()):
            last = tum.last
            out["signals"][name] = {
                "rolling_sum": rol.sum, "rolling_count": rol.count,
                "rate_per_s": rol.rate, "late": tum.late,
                "closed_windows": len(tum.closed),
                "last_window": None if last is None else last.as_dict()}
        for name, h in sorted(self.hists.items()):
            out["histograms"][name] = h.snapshot()
        return out
