"""Bounded incident flight recorder with deterministic replay
(DESIGN.md §17).

The serve pipelines are deterministic functions of their merged event
stream: micro-batch formation depends only on accumulated arrival
counts, departures and cap windows apply at their merged-stream
positions, and placement is a pure function of the state. So a
recorder that copies every merged *run* (arrivals / departures / chassis power
samples) plus every placement decision is enough to reconstruct an
incident exactly — no RNG state, no wall clock, no device state.

`FlightRecorder` keeps one ordered, row-bounded timeline of those
runs (a single deque, so eviction keeps the timeline consistent — we
never hold a decision whose causing arrivals were dropped) and a
small ring of `Incident` markers stamped by the emergency plane when
alarms fire. `replay` re-drives a fresh caller-built pipeline through
the recorded stream via the public `submit_to` / `depart_to` /
`cap_to` API; `verify_replay` asserts the replayed placement
decisions are bit-identical to the recorded ones — the
decision-identity acceptance check, and the post-incident "can we
reproduce it?" tool.

Only the streamed (queue) path is recorded: direct `serve()` calls
bypass the ingest merge and are not replayable. Recording is
host-side copying only — the decision path never reads the recorder,
preserving the on/off bit-identity of decisions.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Run", "Incident", "FlightRecorder", "replay",
           "verify_replay"]

#: Run kinds on the recorded timeline.
KINDS = ("arrival", "departure", "capping", "decision")


@dataclass(frozen=True)
class Run:
    """One recorded merged-stream run: ``kind`` (see ``KINDS``), a
    monotone sequence number, the per-event stamp array ``t`` (None
    for decision rows, which carry the serving watermark in
    ``payload``), and a dict of copied numpy columns."""
    seq: int
    kind: str
    t: object
    payload: dict

    @property
    def rows(self) -> int:
        """Row count this run charges against the capacity budget."""
        n = 0
        for v in self.payload.values():
            if isinstance(v, np.ndarray):
                n = max(n, len(v))
        return max(n, 1)


@dataclass(frozen=True)
class Incident:
    """One alarm marker: the watermark ``t`` it fired at, the alarm
    count, a counter snapshot, and the timeline sequence number it
    points into (`FlightRecorder.incident_window` slices around it)."""
    seq: int
    t: float
    alarms: int
    counters: dict = field(default_factory=dict)


class FlightRecorder:
    """Row-bounded timeline of merged-stream runs + incident markers.

    ``capacity_rows`` bounds total payload rows (oldest runs evicted
    first; ``wrapped`` reports whether anything was lost — `replay`
    refuses a wrapped recorder because the stream prefix is gone).
    ``incident_capacity`` bounds the marker ring."""

    def __init__(self, capacity_rows: int = 65536,
                 incident_capacity: int = 64):
        if capacity_rows < 1 or incident_capacity < 1:
            raise ValueError(
                f"capacities must be >= 1, got {capacity_rows}, "
                f"{incident_capacity}")
        self.capacity_rows = int(capacity_rows)
        self.timeline: deque = deque()
        self.incidents: deque = deque(maxlen=int(incident_capacity))
        self.rows = 0
        self.dropped_runs = 0
        self._seq = 0

    @property
    def wrapped(self) -> bool:
        """True once any run has been evicted (replay impossible)."""
        return self.dropped_runs > 0

    # -- recording ---------------------------------------------------------
    def _push(self, kind: str, t, payload: dict) -> None:
        run = Run(self._seq, kind, t, payload)
        self._seq += 1
        self.timeline.append(run)
        self.rows += run.rows
        while self.rows > self.capacity_rows and len(self.timeline) > 1:
            gone = self.timeline.popleft()
            self.rows -= gone.rows
            self.dropped_runs += 1

    @staticmethod
    def _copy_soa(batch) -> dict:
        """Copy a SoA dataclass batch field-by-field (None passes
        through for optional columns)."""
        out = {}
        for name in type(batch).__dataclass_fields__:
            v = getattr(batch, name)
            out[name] = None if v is None else np.array(v, copy=True)
        return out

    def record_arrivals(self, t, batch) -> None:
        """Record one merged arrival run (an `ArrivalBatch` slice,
        ground-truth columns included) stamped ``t``."""
        self._push("arrival", np.array(t, copy=True),
                   self._copy_soa(batch))

    def record_departures(self, t, batch) -> None:
        """Record one merged departure run (a `DepartureBatch`
        slice) stamped ``t``."""
        self._push("departure", np.array(t, copy=True),
                   self._copy_soa(batch))

    def record_caps(self, t, batch) -> None:
        """Record one merged chassis power-sample run (a `CapBatch`
        slice) stamped ``t``."""
        self._push("capping", np.array(t, copy=True),
                   self._copy_soa(batch))

    def record_decision(self, servers, watermark: float = 0.0) -> None:
        """Record one micro-batch's placement decision (assigned
        server per arrival, -1 = rejected) at the serving
        watermark."""
        self._push("decision", None,
                   {"server": np.array(servers, copy=True),
                    "watermark": float(watermark)})

    def mark_incident(self, t: float, alarms: int,
                      counters: dict | None = None) -> Incident:
        """Stamp an alarm marker at the current timeline position with
        a copy of whatever counter values the caller passes."""
        inc = Incident(self._seq, float(t), int(alarms),
                       dict(counters or {}))
        self.incidents.append(inc)
        return inc

    # -- reads -------------------------------------------------------------
    def incident_window(self, incident: Incident,
                        context_runs: int = 64) -> list:
        """The up-to-``context_runs`` timeline runs leading up to (and
        including) the incident's sequence position."""
        runs = [r for r in self.timeline if r.seq <= incident.seq]
        return runs[-context_runs:]

    def decisions(self) -> np.ndarray:
        """All recorded placement decisions, concatenated in stream
        order (empty int32 array when none)."""
        parts = [r.payload["server"] for r in self.timeline
                 if r.kind == "decision"]
        if not parts:
            return np.zeros(0, np.int32)
        return np.concatenate(parts)

    def summary(self) -> dict:
        """JSON-ready view: occupancy, per-kind run counts, and the
        incident markers."""
        kinds = {k: 0 for k in KINDS}
        for r in self.timeline:
            kinds[r.kind] += 1
        return {"rows": self.rows, "capacity_rows": self.capacity_rows,
                "runs": len(self.timeline), "by_kind": kinds,
                "dropped_runs": self.dropped_runs,
                "wrapped": self.wrapped,
                "incidents": [
                    {"seq": i.seq, "t": i.t, "alarms": i.alarms,
                     "counters": dict(i.counters)}
                    for i in self.incidents]}


def replay(recorder: FlightRecorder, pipeline) -> np.ndarray:
    """Re-drive ``pipeline`` (a fresh, caller-built pipeline in the
    same configuration — same model, budget, shard count, and
    emergency/adaptive planes) through the recorded stream and return
    the replayed placement decisions in stream order.

    Everything is pushed through host 0 of the public queue API with
    the recorded stamps: the merge already serialized the original
    multi-host stream into watermark order, so a single-host replay
    of that order reproduces the identical merged stream. Raises if
    the recorder wrapped (the stream prefix was evicted) — a partial
    replay would diverge and assert nothing."""
    from repro_torch.serve.ingest import CapBatch, DepartureBatch
    from repro_torch.sim.telemetry import ArrivalBatch

    if recorder.wrapped:
        raise ValueError(
            f"recorder wrapped ({recorder.dropped_runs} runs "
            "evicted); cannot replay a truncated stream — raise "
            "capacity_rows or snapshot earlier")
    out = []
    for run in recorder.timeline:
        if run.kind == "arrival":
            res = pipeline.submit_to(
                0, ArrivalBatch(**run.payload), t=run.t)
        elif run.kind == "departure":
            d = DepartureBatch(**run.payload)
            res = pipeline.depart_to(
                0, d.server, d.cores, d.p95_eff, d.is_uf,
                t=run.t, mem_gb=d.mem_gb)
        elif run.kind == "capping":
            c = CapBatch(**run.payload)
            res = pipeline.cap_to(0, c.chassis, c.power_w, t=run.t)
        else:                        # decision rows are the *expected*
            continue                 # outputs, not inputs
        out.extend(np.asarray(r.server) for r in res)
    tail = pipeline.flush()
    if tail is not None:
        out.append(np.asarray(tail.server))
    if not out:
        return np.zeros(0, np.int32)
    return np.concatenate(out)


def verify_replay(recorder: FlightRecorder, pipeline) -> np.ndarray:
    """`replay` + assert the replayed decisions match the recorded
    ones bit-for-bit; returns the decisions on success."""
    got = replay(recorder, pipeline)
    want = recorder.decisions()
    if got.shape != want.shape:
        raise AssertionError(
            f"replay decision count {got.shape} != recorded "
            f"{want.shape}")
    if not np.array_equal(got, want):
        bad = np.flatnonzero(got != want)
        raise AssertionError(
            f"replay diverged at {bad.size} / {want.size} decisions "
            f"(first at stream index {bad[0]}: replayed "
            f"{got[bad[0]]}, recorded {want[bad[0]]})")
    return got
