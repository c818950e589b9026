"""Per-host ingest: timestamp-merged arrival, departure and power-sample
streams, the counterpart of `repro.serve.ingest` (host numpy, carried
over unchanged so the same pushes give the same merged stream).

There is no global arrival queue in a production setting: many hosts
feed placement concurrently. So:

  * **One queue per host.** Each ingest host owns a `HostQueue` — a
    FIFO of *stamped* event chunks (arrival micro-batches, departure
    batches, chassis power samples); stamps are non-decreasing within
    a chunk and every chunk starts strictly after the host's last
    stamp. Hosts never talk to each other; pushing is a local append.
  * **Deterministic timestamp merge.** `IngestMux.poll` runs a stable
    watermark-based k-way merge over the host queues: only events
    with ``t <= min over hosts of last-pushed t`` are released (no
    host can later push an earlier event), in ``(t, host_id, seq)``
    order — ties across hosts break toward the smaller host id, ties
    within a host toward the earlier push. The merge walks the K
    sorted host windows with vectorized two-way merges
    (`numpy.searchsorted`); the full stream is **never sorted** and
    never lives in one queue.
  * **Departures and power samples ride the same streams.** A host's
    departure batches and cap samples interleave with its arrivals at
    their stamped position, so freed capacity and emergency state
    change in one deterministic order.

When every event carries a globally unique timestamp the merged order
— and therefore every placement decision downstream — is invariant to
how events were dealt across host queues. With one host the merge is
the identity and the pipeline degenerates to the single-queue path.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from repro_torch.sim.telemetry import ArrivalBatch

#: Event kinds in a merged stream (`MergedEvents.kind`).
ARRIVAL = 0
DEPARTURE = 1
CAPPING = 2


@dataclass
class DepartureBatch:
    """Struct-of-arrays batch of VM departures — the departure twin of
    `repro_torch.sim.telemetry.ArrivalBatch` (global server ids; negative
    ids are ignored by every consumer). Rows with ``cores < 0`` are
    *pinned arrivals* (an exact placement onto `server` — the encoding
    `serve.mitigation` uses for the arrive leg of a migration pair):
    `serve.placement.remove_batch` is sign-symmetric, so
    the same consumers handle both directions."""
    server: np.ndarray              # (B,) int32 — global server id
    cores: np.ndarray               # (B,) float32
    p95_eff: np.ndarray             # (B,) float32 — p95 at placement
    is_uf: np.ndarray               # (B,) bool
    mem_gb: np.ndarray = None       # (B,) float32 — GB recorded at placement

    def __post_init__(self):
        if self.mem_gb is None:
            self.mem_gb = np.zeros_like(
                np.asarray(self.cores, np.float32))

    def __len__(self) -> int:
        return len(self.server)


@dataclass
class CapBatch:
    """Struct-of-arrays batch of per-chassis power samples — the third
    stream-event kind (`CAPPING`), feeding the online power-emergency
    plane (`repro_torch.serve.emergency`).

    A sample at/above the alarm threshold is a *cap* event (the
    emergency controller apportions a cut at the event's merged
    position); a sample below it is an *uncap* event (it starts or
    advances the lift clock). Routing raw samples instead of
    pre-chewed cap/uncap verdicts keeps every host stateless — the
    hysteresis lives in one place, the emergency state, and applies in
    deterministic merged order."""
    chassis: np.ndarray             # (B,) int32 — global chassis id
    power_w: np.ndarray             # (B,) float32 — sampled chassis draw

    def __len__(self) -> int:
        return len(self.chassis)


def slice_soa(batch, lo: int, hi: int):
    """Row-slice a struct-of-arrays dataclass (`ArrivalBatch` or
    `DepartureBatch`)."""
    cls = type(batch)
    return cls(*(getattr(batch, f.name)[lo:hi]
                 for f in dataclasses.fields(cls)))


def _concat_soa(cls, parts: list):
    """Concatenate struct-of-arrays dataclass batches. An empty parts
    list yields the typed empty batch — column dtypes must survive
    (downstream indexing and the serve path depend on them)."""
    if not parts:
        return _empty_of(cls)
    return cls(*(np.concatenate([getattr(p, f.name) for p in parts])
                 for f in dataclasses.fields(cls)))


def empty_departures() -> DepartureBatch:
    """A zero-length `DepartureBatch` (typed empty columns)."""
    return DepartureBatch(np.empty(0, np.int32), np.empty(0, np.float32),
                          np.empty(0, np.float32), np.empty(0, bool),
                          np.empty(0, np.float32))


def empty_arrivals() -> ArrivalBatch:
    """A zero-length `ArrivalBatch` (typed empty columns)."""
    return ArrivalBatch(np.empty(0, np.int32), np.empty(0, np.float32),
                        np.empty(0, np.float32), np.empty(0, np.int32),
                        np.empty(0, bool), np.empty(0, np.float32),
                        np.empty(0, np.float32))


def empty_caps() -> CapBatch:
    """A zero-length `CapBatch` (typed empty columns)."""
    return CapBatch(np.empty(0, np.int32), np.empty(0, np.float32))


#: Payload batch type / empty-batch factory of each event kind,
#: indexed by kind code.
_KIND_CLS = (ArrivalBatch, DepartureBatch, CapBatch)
_KIND_EMPTY = (empty_arrivals, empty_departures, empty_caps)
_N_KINDS = len(_KIND_CLS)


def _empty_of(cls):
    return _KIND_EMPTY[_KIND_CLS.index(cls)]()


class HostQueue:
    """One ingest host's local event queue.

    Events are pushed in stamped chunks (an `ArrivalBatch` or a
    `DepartureBatch` plus per-row timestamps); stamps are
    non-decreasing within a chunk (ties keep push order — the seq
    tie-break) and every chunk must start strictly after the host's
    last stamp. That monotonicity is what lets the mux release events
    at or below the fleet watermark without risking a late
    out-of-order push. Pushing is purely local: no lock, no
    cross-host traffic.
    """

    def __init__(self, host_id: int):
        self.host_id = int(host_id)
        self._chunks: list = []       # [stamps, kind, payload, offset]
        self._last_t = -np.inf
        self._closed = False
        self._n = 0

    def __len__(self) -> int:
        return self._n

    @property
    def watermark(self) -> float:
        """Highest timestamp this host can no longer push below:
        its last-pushed stamp, ``+inf`` once closed, ``-inf`` while it
        has never pushed (an idle host holds the whole merge back —
        close it or advance its clock with `heartbeat`)."""
        return np.inf if self._closed else self._last_t

    def _stamp(self, t, n: int) -> np.ndarray:
        if self._closed:
            raise ValueError(f"host {self.host_id} is closed")
        if t is None:
            base = 0.0 if np.isinf(self._last_t) else self._last_t
            stamps = base + np.arange(1, n + 1, dtype=np.float64)
        else:
            stamps = np.broadcast_to(
                np.asarray(t, np.float64), (n,)).copy() \
                if np.ndim(t) == 0 else np.asarray(t, np.float64)
            if stamps.shape != (n,):
                raise ValueError(
                    f"need {n} stamps, got shape {stamps.shape}")
        if n and not (stamps[0] > self._last_t
                      and (np.diff(stamps) >= 0).all()):
            raise ValueError(
                f"host {self.host_id}: chunk stamps must be "
                f"non-decreasing and start strictly after the last "
                f"push (last={self._last_t})")
        return stamps

    def heartbeat(self, t) -> None:
        """Advance this host's clock to `t` without pushing events —
        the idle host's promise that nothing earlier than `t` is
        coming, so it stops holding the fleet watermark back."""
        if self._closed:
            raise ValueError(f"host {self.host_id} is closed")
        t = float(t)
        if not t > self._last_t:
            raise ValueError(
                f"host {self.host_id}: heartbeat {t} must be strictly "
                f"after the last stamp ({self._last_t})")
        self._last_t = t

    def _push(self, kind: int, batch, t) -> None:
        """Shared append of one stamped chunk of any event kind (an
        empty batch with a scalar `t` degrades to a `heartbeat`)."""
        if not len(batch):
            if t is not None and np.ndim(t) == 0:
                self.heartbeat(t)
            return
        stamps = self._stamp(t, len(batch))
        self._chunks.append([stamps, kind, batch, 0])
        self._last_t = float(stamps[-1])
        self._n += len(batch)

    def push_arrivals(self, batch: ArrivalBatch, t=None) -> None:
        """Append a stamped arrival chunk. `t`: per-row stamps ((B,)
        array, non-decreasing, first strictly after the host's last
        push), a scalar stamping the whole chunk, or None for the
        host-local unit clock (last + 1, +2, ...). An empty batch with
        a scalar `t` is a `heartbeat`."""
        self._push(ARRIVAL, batch, t)

    def push_departures(self, batch: DepartureBatch, t=None) -> None:
        """Append a stamped departure chunk (same stamping contract as
        `push_arrivals` — all kinds share the host's clock)."""
        self._push(DEPARTURE, batch, t)

    def push_caps(self, batch: CapBatch, t=None) -> None:
        """Append a stamped chassis power-sample chunk (`CAPPING` — the
        emergency plane's cap/uncap events; same stamping contract as
        `push_arrivals`, all three kinds share the host's clock)."""
        self._push(CAPPING, batch, t)

    def close(self) -> None:
        """Mark the stream ended: the host's watermark becomes +inf so
        it never again holds the fleet merge back."""
        self._closed = True

    def _take(self, up_to: float):
        """Consume this host's window of events with ``t <= up_to``:
        returns (stamps, kind, per-kind payload batches, kind-local
        index) in push order. Chunks are internally sorted, so the cut
        is one searchsorted per touched chunk."""
        ts, kinds, kidx = [], [], []
        parts = [[] for _ in range(_N_KINDS)]
        counts = [0] * _N_KINDS
        keep = 0
        for chunk in self._chunks:
            stamps, kind, payload, off = chunk
            hi = int(np.searchsorted(stamps[off:], up_to, side="right")) \
                + off
            if hi > off:
                ts.append(stamps[off:hi])
                kinds.append(np.full(hi - off, kind, np.int8))
                kidx.append(counts[kind] + np.arange(hi - off))
                parts[kind].append(slice_soa(payload, off, hi))
                counts[kind] += hi - off
                self._n -= hi - off
                chunk[3] = hi
            if hi < len(stamps):
                self._chunks[keep] = chunk
                keep += 1
        del self._chunks[keep:]
        if not ts:
            return None
        return (np.concatenate(ts), np.concatenate(kinds),
                tuple(_concat_soa(cls, p)
                      for cls, p in zip(_KIND_CLS, parts)),
                np.concatenate(kidx).astype(np.int64))


class MergedEvents(NamedTuple):
    """One poll's released events in merged ``(t, host, seq)`` order.

    `kind[e]` says whether event *e* is an arrival, a departure, or a
    chassis power sample; the payload rows live packed (in merged
    order, per kind) in `arrivals` / `departures` / `caps`, so
    consecutive same-kind events form contiguous row runs — `runs()`
    walks them."""
    t: np.ndarray                   # (E,) f64 — merged stamps
    host: np.ndarray                # (E,) i32 — source host
    kind: np.ndarray                # (E,) i8  — ARRIVAL|DEPARTURE|CAPPING
    arrivals: ArrivalBatch          # arrival-event rows, merged order
    departures: DepartureBatch      # departure-event rows, merged order
    caps: CapBatch                  # power-sample rows, merged order

    def __len__(self) -> int:
        return len(self.t)

    def runs(self):
        """Yield ``(kind, lo, hi)`` maximal same-kind runs; (lo, hi)
        index into the kind's packed batch (`arrivals` for ARRIVAL
        runs, `departures` for DEPARTURE runs, `caps` for CAPPING
        runs)."""
        if not len(self.kind):
            return
        bounds = np.flatnonzero(np.diff(self.kind)) + 1
        starts = np.concatenate([[0], bounds, [len(self.kind)]])
        cursors = [0] * _N_KINDS
        for s, e in zip(starts[:-1], starts[1:]):
            k, n = int(self.kind[s]), int(e - s)
            yield k, cursors[k], cursors[k] + n
            cursors[k] += n


def _merge_two(a: dict, b: dict) -> dict:
    """Stable two-way merge of two sorted event windows. Every host id
    in `a` must be smaller than every host id in `b`, so an exact
    timestamp tie resolves toward `a` (``side='right'``) — exactly the
    (t, host_id) order the k-way merge promises."""
    pos = np.searchsorted(a["t"], b["t"], side="right")
    n = len(a["t"]) + len(b["t"])
    from_b = np.zeros(n, bool)
    from_b[pos + np.arange(len(b["t"]))] = True
    out = {}
    for key in a:
        va, vb = a[key], b[key]
        merged = np.empty(n, va.dtype)
        merged[~from_b] = va
        merged[from_b] = vb
        out[key] = merged
    return out


def _merge_windows(windows: list) -> dict | None:
    """Tournament-reduce the per-host windows with `_merge_two`:
    merging *adjacent* pairs keeps every left window's host ids below
    every right window's (inputs are in host-id order), so ties stay
    correct at every level — and each event is copied O(log K) times,
    not O(K) as a left fold would."""
    if not windows:
        return None
    while len(windows) > 1:
        windows = [_merge_two(windows[i], windows[i + 1])
                   if i + 1 < len(windows) else windows[i]
                   for i in range(0, len(windows), 2)]
    return windows[0]


def kway_merge(stamps_by_host: list) -> tuple:
    """Stable watermark-free k-way merge of per-host stamp arrays.

    Each input array must be sorted (a host stream is); returns
    ``(host, idx)`` — the merged order as (source host, index within
    that host's array), sorted by ``(t, host, seq)`` with ties broken
    toward the smaller host id and, within a host, the earlier event.
    This is the exact merge `IngestMux` runs per poll, exposed for the
    scheduler simulation and for oracle tests (it must agree with an
    ``np.lexsort`` of the concatenated keys)."""
    merged = _merge_windows(
        [{"t": np.asarray(s, np.float64),
          "host": np.full(len(s), h, np.int32),
          "idx": np.arange(len(s), dtype=np.int64)}
         for h, s in enumerate(stamps_by_host)])
    if merged is None:
        return (np.empty(0, np.int32), np.empty(0, np.int64))
    return merged["host"], merged["idx"]


class IngestMux:
    """N per-host event queues + the deterministic timestamp merge.

    The mux is the cross-host ingest stage of the serve pipeline:
    producers push stamped arrival/departure chunks
    into their own `HostQueue`; `poll` releases the merged prefix of
    events no host can still get in front of (the fleet watermark);
    `drain` releases everything regardless of watermark (end of
    stream, or a flush). There is no global queue and the merge never
    sorts the full stream — it k-way-merges the K already-sorted host
    windows."""

    def __init__(self, n_hosts: int = 1):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        self.hosts = [HostQueue(h) for h in range(n_hosts)]

    @property
    def n_hosts(self) -> int:
        """Number of per-host queues."""
        return len(self.hosts)

    @property
    def n_pending(self) -> int:
        """Events pushed but not yet released by a poll/drain."""
        return sum(len(h) for h in self.hosts)

    @property
    def watermark(self) -> float:
        """Fleet watermark: ``min`` over hosts of their last-pushed
        stamp — the largest t no host can still push at or below."""
        return min(h.watermark for h in self.hosts)

    def submit_to(self, host: int, batch: ArrivalBatch, t=None) -> None:
        """Push a stamped arrival chunk into `host`'s queue."""
        self.hosts[host].push_arrivals(batch, t)

    def depart_to(self, host: int, batch: DepartureBatch,
                  t=None) -> None:
        """Push a stamped departure chunk into `host`'s queue."""
        self.hosts[host].push_departures(batch, t)

    def cap_to(self, host: int, batch: CapBatch, t=None) -> None:
        """Push a stamped chassis power-sample chunk into `host`'s
        queue (the emergency plane's cap/uncap events)."""
        self.hosts[host].push_caps(batch, t)

    def heartbeat(self, host: int, t) -> None:
        """Advance `host`'s clock to `t` without events (see
        `HostQueue.heartbeat`) — the idle-host escape hatch."""
        self.hosts[host].heartbeat(t)

    def close(self, host: int) -> None:
        """Close one host's stream (its watermark becomes +inf)."""
        self.hosts[host].close()

    def _emit(self, up_to: float) -> MergedEvents:
        taken = [(h.host_id, h._take(up_to)) for h in self.hosts]
        windows = []
        by_host = [{} for _ in range(_N_KINDS)]
        for hid, w in taken:
            if w is None:
                continue
            ts, kinds, batches, kidx = w
            windows.append({"t": ts,
                            "host": np.full(len(ts), hid, np.int32),
                            "kind": kinds, "kidx": kidx})
            for k in range(_N_KINDS):
                by_host[k][hid] = batches[k]
        merged = _merge_windows(windows)
        if merged is None:
            return MergedEvents(np.empty(0), np.empty(0, np.int32),
                                np.empty(0, np.int8), empty_arrivals(),
                                empty_departures(), empty_caps())

        def pack(empty, kind):
            # the typed empty batch is the dtype authority: a host
            # window may hold zero rows of this kind, and its columns
            # must not leak a default dtype into the merged batch
            sel = merged["kind"] == kind
            n = int(sel.sum())
            if n == 0:
                return empty
            src_host, src_idx = merged["host"][sel], merged["kidx"][sel]
            cols = []
            for f in dataclasses.fields(type(empty)):
                col = np.empty(n, getattr(empty, f.name).dtype)
                for hid, b in by_host[kind].items():
                    mine = src_host == hid
                    if mine.any():
                        col[mine] = getattr(b, f.name)[src_idx[mine]]
                cols.append(col)
            return type(empty)(*cols)

        return MergedEvents(
            merged["t"], merged["host"], merged["kind"],
            pack(empty_arrivals(), ARRIVAL),
            pack(empty_departures(), DEPARTURE),
            pack(empty_caps(), CAPPING))

    def poll(self) -> MergedEvents:
        """Release every event at or below the fleet watermark, in
        merged ``(t, host, seq)`` order. Safe: per-host stamps are
        strictly increasing, so no host can later push an event that
        belonged before anything released here."""
        w = self.watermark
        if np.isneginf(w):
            return self._emit(-np.inf)
        return self._emit(w)

    def drain(self) -> MergedEvents:
        """Release everything currently queued, watermark ignored (in
        the same merged order). Deterministic given the queue contents
        — used by `ServePipeline.flush` and at end of stream. Queues
        stay open; later pushes must still advance each host's
        clock."""
        return self._emit(np.inf)
