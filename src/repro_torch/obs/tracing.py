"""Span tracing: the serve pipeline's stages and the LM prefill step.

`SpanTracer` times each serve pipeline stage (ingest -> merge ->
featurize -> infer -> place -> commit, plus emergency sweeps and
migrations) under a `Span` context manager that records wall-clock
duration twice: into a bounded ring of the most recent spans (`tail`)
and into a log-bucketed histogram in the `MetricsRegistry`
(``serve_span_seconds{span=...}``, which `launch.monitor` reads through
`totals`, so long-run latency distributions survive after the ring
wraps).

Serve spans use `time.perf_counter` and happen entirely on the host: a
span is a host-clock wall, never a device time, and tracing adds no
synchronisation, so it can never perturb a decision or the timing of
the path it measures. On the card the launches are asynchronous:
`featurize`, `infer` and `place` time mostly their launches (a
sharded round or a fused cap sweep reads its counters back inside
`place`), and `commit` holds the copy to the host that waits for the
card to finish. For device-level detail, `SpanTracer.torch_profile`
brackets a region with ``torch.profiler`` and writes a Chrome trace.

`StepTracer` records the spans of a model step: a root span a batch
(its sequence number is the batch's id, shared by every span of the
batch) and the spans opened inside it, each with its parent, its layer
index where it has one, its start on `time.time_ns` (the clock
``torch.profiler`` stamps its events with, so spans and a device trace
share one timeline), its host duration, its device duration and the
counts it carries. On a CUDA device the device duration comes from a
pair of timing events recorded at enter and exit, and a count given as
a tensor is summed into a device buffer: both are read back only when
the ring is read (`resolve`, one synchronise), never on the path they
time. On the CPU work runs synchronously, so the host duration is the
device duration. While ``torch.profiler`` records, each span also opens
a ``record_function`` of its name, so `torch_profile`'s Chrome trace
shows the kernels under the span that launched them; with no profiler
on, no such range is built. Nothing records while the current stream
captures a CUDA graph. A step tracer feeds no histogram.

`launch.steps.make_prefill_step` records into the process's step tracer,
`STEP_TRACER` (4,096 spans), by default: its root makes that tracer the
current one for the call, and the spans deeper down
(`models.transformer`, `models.attention`, `models.moe`) find it through
`step_span`. Where no tracer is current (decode, training, evaluation),
`step_span` reads one global and returns a no-op context. The
benchmark's MoE metrics (`portbench/metrics/moe_us_per_token.prefill.py`
and beside it) read the ring through `StepTracer.batches`. One thread
drives a step tracer.
"""
from __future__ import annotations

import contextlib
import os
import time
from time import perf_counter_ns, time_ns

import numpy as np

from .registry import MetricsRegistry

__all__ = ["Span", "SpanTracer", "StepSpan", "StepTracer", "STEP_TRACER",
           "step_span"]

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


#: The counts a step span may carry; -1 where it carries none.
STEP_COUNTS = ("tokens", "rows", "kept")

_STEP_DTYPE = np.dtype([
    ("seq", np.int64),          # monotone span sequence number
    ("name", "U24"),            # span name (truncated to 24 chars)
    ("layer", np.int32),        # layer index, -1 where none
    ("parent", np.int64),       # the parent span's seq, -1 for a root
    ("batch", np.int64),        # the root span's seq
    ("t0_ns", np.int64),        # time.time_ns at enter
    ("host_ns", np.int64),      # host duration
    ("device_ns", np.float64),  # device duration
    *[(c, np.int64) for c in STEP_COUNTS],
])
_COUNT_NAMES = frozenset(STEP_COUNTS)
_SEQ, _DEV = 0, 7               # fields of a ring slot (a list)
_profiling = None               # torch's cheap "is a profiler on" test


def _profiler_on() -> bool:
    global _profiling
    if _profiling is None:
        import torch
        _profiling = torch._C._autograd._profiler_enabled
    return _profiling()


class StepSpan(Span):
    """One span of a model step (`StepTracer.span`). A span opened while
    none of its tracer's is open is a root: it takes `device` (the
    batch's device; None is the host) and makes its tracer the current
    one until it closes. The others take their root's device, and their
    parent's layer unless given one."""

    __slots__ = ("layer", "device", "counts", "seq", "parent", "batch",
                 "p0", "stream", "events", "rf", "root", "prev")

    def __init__(self, tracer: "StepTracer", name: str, layer: int,
                 device, counts: dict):
        self.tracer, self.name, self.layer = tracer, name, layer
        self.device, self.counts, self.root = device, counts, False

    def __enter__(self) -> "StepSpan":
        tr = self.tracer
        stack = tr._stack
        if stack:
            top = stack[-1]
            if self.layer < 0:
                self.layer = top.layer
            self.parent, self.batch = top.seq, top.batch
            self.stream = top.stream
        elif not self._open_root():
            self.seq = None
            return self
        self.seq = seq = tr._next_seq
        tr._next_seq += 1
        if self.root:
            self.batch = seq
        slot = seq & (tr.capacity - 1)
        self.rf = None
        if _profiler_on():
            import torch
            self.rf = torch.ops.profiler._record_function_enter_new(
                self.name, None)
        stack.append(self)
        self.events = None
        if self.stream is not None:
            self.events = tr._events_at(slot)
            self.events[0].record(self.stream)
        self.t0 = time_ns()
        self.p0 = perf_counter_ns()
        return self

    def _open_root(self) -> bool:
        """Open as a root, unless the device is neither the host nor a
        card or the current stream is capturing a graph: then the span
        and everything under it record nothing."""
        global _ACTIVE
        import torch
        kind = "cpu" if self.device is None else \
            torch.device(self.device).type
        self.stream = None
        if kind == "cuda":
            if torch.cuda.is_current_stream_capturing():
                return False
            self.stream = torch.cuda.current_stream(self.device)
        elif kind != "cpu":
            return False
        self.root, self.parent = True, -1
        self.prev, _ACTIVE = _ACTIVE, self.tracer
        return True

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        if self.seq is None:
            return
        if self.events is not None:
            self.events[1].record(self.stream)
        host_ns = perf_counter_ns() - self.p0
        self.dur = host_ns / 1e9
        tr = self.tracer
        if self.rf is not None:
            import torch
            torch.ops.profiler._record_function_exit._RecordFunction(self.rf)
        tr._stack.pop()
        slot = self.seq & (tr.capacity - 1)
        row = [self.seq, self.name[:24], self.layer, self.parent,
               self.batch, self.t0, host_ns,
               None if self.events is not None else float(host_ns),
               -1, -1, -1]
        for name, value in self.counts.items():
            if isinstance(value, int):
                row[_DEV + 1 + STEP_COUNTS.index(name)] = value
            else:
                # summed after the span's own work, outside its times
                tr._defer(slot, self.seq, name, value)
        tr._slots[slot] = row
        if self.root:
            _ACTIVE = self.prev


class StepTracer(SpanTracer):
    """Bounded recorder of a model step's spans (module docstring). The
    ring holds the most recent `capacity` spans (power-of-two sized), as
    Python lists until read; `resolve` reads the device's part back and
    returns them as one array."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.registry = None
        self.capacity = 1 << (capacity - 1).bit_length()
        self._slots = [None] * self.capacity
        self._stack = []
        self._next_seq = 0
        self._events = None         # (start, end) timing events a slot
        self._device = None         # the card the events time
        self._counts = None         # (capacity, counts) int64 on a device
        self._deferred = {}         # (slot, count column) -> seq
        self._profiles = 0
        self.last_profile = None

    def span(self, name: str, layer: int = -1, device=None,
             **counts) -> StepSpan:
        """Context manager recording one span `name` (at `layer`), with
        the counts of `STEP_COUNTS` it carries: an int, or a tensor whose
        sum is taken on its device and read back by `resolve`. `device`
        matters only to a root (`StepSpan`)."""
        if counts and not counts.keys() <= _COUNT_NAMES:
            raise ValueError(f"unknown counts {sorted(counts)}: a step "
                             f"span carries {STEP_COUNTS}")
        return StepSpan(self, name, layer, device, counts)

    def _events_at(self, slot: int) -> tuple:
        """The slot's timing events, made (and each recorded once, which
        creates it) on the card the first time one is needed."""
        if self._events is None:
            import torch
            stream = self._stack[0].stream
            self._device = stream.device
            self._events = [
                (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
                for _ in range(self.capacity)]
            for pair in self._events:
                for ev in pair:
                    ev.record(stream)
        return self._events[slot]

    def _defer(self, slot: int, seq: int, name: str, value) -> None:
        """Sum `value` on its device into the count buffer's (slot,
        count) cell, with no read-back."""
        import torch
        if self._counts is None or self._counts.device != value.device:
            self._read_counts()
            self._counts = torch.full((self.capacity, len(STEP_COUNTS)), -1,
                                      dtype=torch.int64, device=value.device)
        col = STEP_COUNTS.index(name)
        torch.sum(value.reshape(-1), 0, dtype=torch.int64,
                  out=self._counts[slot, col])
        self._deferred[slot, col] = seq

    def _read_counts(self) -> None:
        if not self._deferred:
            return
        host = self._counts.cpu().numpy()
        for (slot, col), seq in self._deferred.items():
            row = self._slots[slot]
            if row is not None and row[_SEQ] == seq:
                row[_DEV + 1 + col] = int(host[slot, col])
        self._deferred.clear()

    def __len__(self) -> int:
        return sum(s is not None for s in self._slots)

    def resolve(self) -> np.ndarray:
        """Every span the ring holds, oldest first, with the device
        durations and counts read back (one synchronise of the card)."""
        if self._stack:
            raise RuntimeError("a step span is open: resolve the ring "
                               "between steps")
        held = [s for s in self._slots if s is not None]
        pending = [s for s in held if s[_DEV] is None]
        if pending:
            import torch
            torch.cuda.synchronize(self._device)
            for s in pending:
                start, end = self._events[s[_SEQ] & (self.capacity - 1)]
                s[_DEV] = start.elapsed_time(end) * 1e6
        self._read_counts()
        out = np.array([tuple(s) for s in held], _STEP_DTYPE)
        return out[np.argsort(out["seq"], kind="stable")]

    def tail(self, n: int = 64) -> np.ndarray:
        """The most recent `n` spans, oldest first, resolved."""
        spans = self.resolve()
        return spans[len(spans) - n:] if n > 0 else spans[:0]

    def batches(self, root: str, newest: int | None = None) -> list:
        """The whole batches among the `newest` newest roots named
        `root` that the ring holds, oldest first, each as the array of
        its spans. A batch is whole when the ring holds its root and
        every span opened under it: a batch's spans have the sequence
        numbers from its root's up to the next batch's."""
        spans = self.resolve()
        ids, first, count = np.unique(spans["batch"], return_index=True,
                                      return_counts=True)
        ends = np.append(ids[1:], self._next_seq)
        rooted = (spans["seq"][first] == ids) \
            & (spans["name"][first] == root)
        picked = np.flatnonzero(rooted)
        if newest is not None:
            picked = picked[max(len(picked) - newest, 0):]
        return [spans[first[i]:first[i] + count[i]] for i in picked
                if count[i] == ends[i] - ids[i]]


#: The process's step tracer, the default of `launch.steps.
#: make_prefill_step`.
STEP_TRACER = StepTracer(capacity=4096)
_ACTIVE = None                  # the step tracer of the open root, if any
_OFF = contextlib.nullcontext()


def step_span(name: str, layer: int = -1, **counts):
    """A span of the current step tracer (`StepTracer.span`), or a no-op
    context where none is current."""
    tracer = _ACTIVE
    if tracer is None:
        return _OFF
    return tracer.span(name, layer, **counts)
