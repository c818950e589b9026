"""Span tracing for the serve pipeline.

Each pipeline stage (ingest -> merge -> featurize -> infer -> place ->
commit, plus emergency sweeps and migrations) runs under a `Span`
context manager that records wall-clock duration twice: into a
bounded ring (so `launch.monitor` can render the most recent batches
as a timeline) and into a log-bucketed histogram in the
`MetricsRegistry` (``serve_span_seconds{span=...}``, so long-run
latency distributions survive after the ring wraps).

Timings use `time.perf_counter` and happen entirely on the host: a
span is a host-clock wall, never a device time, and tracing adds no
synchronisation, so it can never perturb a decision or the timing of
the path it measures. On the card the launches are asynchronous:
`featurize`, `infer` and `place` time mostly their launches (a
sharded round or a fused cap sweep reads its counters back inside
`place`), and `commit` holds the copy to the host that waits for the
card to finish. For device-level detail, `SpanTracer.torch_profile`
brackets a region with ``torch.profiler`` and writes a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np

from .registry import MetricsRegistry

__all__ = ["Span", "SpanTracer"]

_SPAN_DTYPE = np.dtype([
    ("seq", np.int64),      # monotone span sequence number
    ("name", "U24"),        # span name (truncated to 24 chars)
    ("t0", np.float64),     # perf_counter start
    ("dur", np.float64),    # seconds
])


class Span:
    """One timed region. Use via ``with tracer.span("place"):`` —
    entering stamps the clock, exiting records the duration into the
    tracer's ring and histogram. Re-entrant use of the same tracer is
    fine (spans nest independently)."""

    __slots__ = ("tracer", "name", "t0", "dur")

    def __init__(self, tracer: "SpanTracer", name: str):
        self.tracer = tracer
        self.name = name
        self.t0 = 0.0
        self.dur = float("nan")

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.dur = time.perf_counter() - self.t0
        self.tracer._record(self)


class SpanTracer:
    """Bounded span recorder bound to a `MetricsRegistry`.

    The ring holds the most recent `capacity` spans (power-of-two
    sized, mask-indexed); every span additionally feeds
    ``serve_span_seconds{span=<name>}`` in the registry, so aggregate
    latency outlives the ring."""

    def __init__(self, registry: MetricsRegistry,
                 capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.registry = registry
        self.capacity = 1 << (capacity - 1).bit_length()
        self._ring = np.zeros(self.capacity, _SPAN_DTYPE)
        self._next_seq = 0
        self._profiles = 0          # Chrome traces written so far
        self.last_profile = None    # path of the newest one

    def __len__(self) -> int:
        return min(self._next_seq, self.capacity)

    def span(self, name: str) -> Span:
        """Context manager timing one region under `name`."""
        return Span(self, name)

    def _record(self, span: Span) -> None:
        i = self._next_seq & (self.capacity - 1)
        self._ring[i] = (self._next_seq, span.name[:24], span.t0,
                         span.dur)
        self._next_seq += 1
        self.registry.histogram(
            "serve_span_seconds",
            help="wall-clock span durations by pipeline stage",
            span=span.name).observe(span.dur)

    def tail(self, n: int = 64) -> np.ndarray:
        """The most recent `n` spans, oldest first (a copy)."""
        n = min(n, len(self))
        if n == 0:
            return np.zeros(0, _SPAN_DTYPE)
        idx = (self._next_seq - n + np.arange(n)) & (self.capacity - 1)
        return self._ring[idx].copy()

    def totals(self) -> dict:
        """``{span name: (count, total seconds)}`` over the whole run,
        read back from the registry histograms (not just the ring)."""
        out = {}
        for (name, labels), m in self.registry._metrics.items():
            if name == "serve_span_seconds":
                span = dict(labels).get("span", "?")
                out[span] = (m.count, m.sum)
        return out

    @contextlib.contextmanager
    def torch_profile(self, log_dir: str, device=None):
        """Bracket a region with ``torch.profiler`` and write its Chrome
        trace (view with Perfetto or ``chrome://tracing``) to
        ``<log_dir>/profile_<k>.json``, k counting this tracer's
        profiles. It records CPU activity, plus CUDA activity when
        `device` is a CUDA device (None: when a card is present).
        Yields the `torch.profiler.profile`. A failure to start, stop
        or write the trace raises: the profiler ships with torch, so a
        silent no-op would only hide a fault."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        if device is None:
            cuda = torch.cuda.is_available()
        else:
            cuda = torch.device(device).type == "cuda"
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"profile_{self._profiles}.json")
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(path)
        self._profiles += 1
        self.last_profile = path
