"""Placement audit trail: a bounded ring of per-arrival decisions.

The paper's black-box constraint means a customer whose VM got capped
can only be answered from telemetry the provider kept — the serve
plane must be able to say, after the fact, *which* chassis a VM
landed on, *which* admission rule admitted it (or which budget
rejected it), and what the power-token pool looked like at that
moment. `AuditTrail` keeps exactly that: one structured-numpy record
per arrival, written from the already-materialised outputs of the
placement step (`servers`, outcome codes, pool level), so the
audited path is decision-bit-identical to the unaudited one — the
device calls never see the trail.

Bounded by construction: a power-of-two-sized ring indexed by a
monotone sequence number, so memory is O(capacity) no matter how long
the pipeline runs, and `tail`/`explain` reconstruct recent history in
order. Outcome codes follow `serve.placement` (server id >= 0 admits;
-1 capacity, -2 chassis power, -3 pool tokens).
"""
from __future__ import annotations

import numpy as np

__all__ = ["AuditRecord", "AuditTrail", "OUTCOME_NAMES",
           "AdaptiveRecord", "AdaptiveTrail"]

#: Decision-outcome code -> human name (codes from `serve.placement`).
OUTCOME_NAMES = {
    0: "admitted",
    -1: "fail_capacity",
    -2: "fail_chassis_power",
    -3: "fail_pool_tokens",
}

#: One decision record. ``server``/``chassis`` are -1 on rejection;
#: ``rule`` is the admission-policy index that produced the decision;
#: ``pool_left`` is the token pool *after* the batch committed.
_DTYPE = np.dtype([
    ("seq", np.int64),          # monotone arrival sequence number
    ("t", np.float64),          # wall-clock seconds (time.time)
    ("batch", np.int64),        # pipeline batch index
    ("slot", np.int32),         # row within the batch
    ("server", np.int32),       # chosen server id, or -1
    ("chassis", np.int32),      # chosen chassis id, or -1
    ("outcome", np.int8),       # 0 admitted / -1 / -2 / -3
    ("rule", np.int8),          # admission policy index
    ("cores", np.float32),      # requested cores
    ("is_uf", np.bool_),        # user-facing criticality flag
    ("p95_eff", np.float32),    # effective p95 utilisation used
    ("conservative", np.bool_),  # admission fell back to conservative
    ("pool_left", np.float32),  # pool tokens after the batch committed
])


class AuditRecord:
    """Read-only view of one audit row with named attributes and a
    human rendering (`AuditTrail.explain` returns these)."""

    __slots__ = ("_row",)

    def __init__(self, row: np.void):
        self._row = row

    def __getattr__(self, name):
        try:
            return self._row[name].item()
        except (KeyError, ValueError):
            raise AttributeError(name) from None

    @property
    def outcome_name(self) -> str:
        """Decision outcome as a string (``admitted`` / ``fail_*``)."""
        code = int(self._row["outcome"])
        return OUTCOME_NAMES.get(code, f"outcome_{code}")

    def describe(self) -> str:
        """One-line human rendering of the decision, the shape quoted
        in the docs/observability.md audit walkthrough."""
        r = self._row
        crit = "UF" if r["is_uf"] else "NUF"
        head = (f"seq={int(r['seq'])} batch={int(r['batch'])}"
                f" slot={int(r['slot'])} {crit}"
                f" cores={float(r['cores']):g}"
                f" p95_eff={float(r['p95_eff']):.4f}")
        if int(r["outcome"]) == 0:
            where = (f"-> server {int(r['server'])}"
                     f" chassis {int(r['chassis'])}"
                     f" rule {int(r['rule'])}")
        else:
            where = f"-> REJECTED ({self.outcome_name})"
        return (f"{head} {where}"
                f" pool_left={float(r['pool_left']):.3f}"
                + (" [conservative]" if r["conservative"] else ""))


class AuditTrail:
    """Bounded ring buffer of placement decisions.

    `record_batch` appends one row per *valid* arrival in a placed
    batch, vectorised (one structured-array write, no per-row Python
    loop on the hot path). Capacity is rounded up to a power of two so
    the ring index is a mask, and the oldest rows are overwritten once
    ``len() == capacity``.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = 1 << (capacity - 1).bit_length()
        self._ring = np.zeros(self.capacity, _DTYPE)
        self._next_seq = 0

    def __len__(self) -> int:
        return min(self._next_seq, self.capacity)

    @property
    def total_recorded(self) -> int:
        """Total rows ever written (>= ``len`` once the ring wraps)."""
        return self._next_seq

    def record_batch(self, *, t: float, batch: int, servers, chassis,
                     rule, cores, is_uf, p95_eff, valid,
                     conservative, pool_left: float) -> int:
        """Append every row of one placed batch where ``valid`` is
        True. All array arguments are batch-shaped ((B,) or scalar-
        broadcastable); ``servers`` < 0 encodes the fail reason.
        Returns the number of rows written."""
        valid = np.asarray(valid, bool)
        n = int(valid.sum())
        if n == 0:
            return 0
        rows = np.zeros(n, _DTYPE)
        rows["seq"] = self._next_seq + np.arange(n)
        rows["t"] = t
        rows["batch"] = batch
        rows["slot"] = np.nonzero(valid)[0]
        srv = np.broadcast_to(np.asarray(servers), valid.shape)[valid]
        rows["server"] = np.where(srv >= 0, srv, -1)
        rows["chassis"] = np.broadcast_to(
            np.asarray(chassis), valid.shape)[valid]
        rows["outcome"] = np.minimum(srv, 0)
        rows["rule"] = np.broadcast_to(
            np.asarray(rule), valid.shape)[valid]
        rows["cores"] = np.broadcast_to(
            np.asarray(cores), valid.shape)[valid]
        rows["is_uf"] = np.broadcast_to(
            np.asarray(is_uf, bool), valid.shape)[valid]
        rows["p95_eff"] = np.broadcast_to(
            np.asarray(p95_eff), valid.shape)[valid]
        rows["conservative"] = np.broadcast_to(
            np.asarray(conservative, bool), valid.shape)[valid]
        rows["pool_left"] = pool_left
        idx = (self._next_seq + np.arange(n)) & (self.capacity - 1)
        self._ring[idx] = rows
        self._next_seq += n
        return n

    def tail(self, n: int = 32) -> np.ndarray:
        """The most recent `n` records, oldest first, as a structured
        array (a copy — safe to hold across further recording)."""
        n = min(n, len(self))
        if n == 0:
            return np.zeros(0, _DTYPE)
        idx = (self._next_seq - n + np.arange(n)) & (self.capacity - 1)
        return self._ring[idx].copy()

    def explain(self, seq: int) -> AuditRecord:
        """Look up one decision by sequence number (raises KeyError if
        it has fallen out of the ring or was never recorded)."""
        if not (0 <= seq < self._next_seq) \
                or seq < self._next_seq - self.capacity:
            raise KeyError(f"seq {seq} not in audit ring "
                           f"(kept: [{max(0, self._next_seq - self.capacity)}"
                           f", {self._next_seq}))")
        return AuditRecord(self._ring[seq & (self.capacity - 1)])

    def rejected(self, n: int = 32) -> list:
        """The most recent rejected decisions (up to `n`), oldest
        first — the starting point of a "why was my VM capped/denied"
        investigation."""
        rows = self.tail(len(self))
        bad = rows[rows["outcome"] < 0]
        return [AuditRecord(r) for r in bad[-n:]]


#: One adaptive-controller decision row (`serve.adaptive`). ``action``
#: is +1 ratchet / 0 hold / -1 backoff; ``reason`` indexes
#: `repro_torch.serve.adaptive.REASON_NAMES`; ``shard`` is -1 unsharded.
_ADAPTIVE_DTYPE = np.dtype([
    ("seq", np.int64),          # monotone decision sequence number
    ("t", np.float64),          # wall-clock seconds (time.time)
    ("shard", np.int16),        # owning shard, or -1 unsharded
    ("ratio", np.float32),      # post-decision oversubscription ratio
    ("stable_frac", np.float32),  # stable / known chassis this scan
    ("n_known", np.int32),      # chassis with enough window history
    ("n_stable", np.int32),     # known chassis scored stable
    ("action", np.int8),        # +1 ratchet / 0 hold / -1 backoff
    ("reason", np.int8),        # index into adaptive.REASON_NAMES
])

_ACTION_NAMES = {1: "ratchet", 0: "hold", -1: "backoff"}


class AdaptiveRecord:
    """Read-only view of one adaptive-controller decision row with
    named attributes and a human rendering (`AdaptiveTrail.explain`
    returns these)."""

    __slots__ = ("_row",)

    def __init__(self, row: np.void):
        self._row = row

    def __getattr__(self, name):
        try:
            return self._row[name].item()
        except (KeyError, ValueError):
            raise AttributeError(name) from None

    @property
    def action_name(self) -> str:
        """Controller action as a string (ratchet / hold / backoff)."""
        return _ACTION_NAMES.get(int(self._row["action"]),
                                 f"action_{int(self._row['action'])}")

    @property
    def reason_name(self) -> str:
        """Decision reason as a string (the `serve.adaptive.
        REASON_NAMES` entry the recorded index points at)."""
        from repro_torch.serve.adaptive import REASON_NAMES
        code = int(self._row["reason"])
        if 0 <= code < len(REASON_NAMES):
            return REASON_NAMES[code]
        return f"reason_{code}"

    def describe(self) -> str:
        """One-line human rendering of the controller decision."""
        r = self._row
        where = "" if int(r["shard"]) < 0 else f" shard={int(r['shard'])}"
        return (f"seq={int(r['seq'])}{where} {self.action_name}"
                f" ({self.reason_name})"
                f" ratio={float(r['ratio']):.3f}"
                f" stable={int(r['n_stable'])}/{int(r['n_known'])}"
                f" frac={float(r['stable_frac']):.3f}")


class AdaptiveTrail:
    """Bounded ring of adaptive-ratio controller decisions — the "why
    did the budget move" sibling of the placement `AuditTrail`, with
    the same power-of-two ring mechanics. One row per controller scan
    (per shard, sharded), written host-side from outputs the step
    already returned, so recording never perturbs a decision."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = 1 << (capacity - 1).bit_length()
        self._ring = np.zeros(self.capacity, _ADAPTIVE_DTYPE)
        self._next_seq = 0

    def __len__(self) -> int:
        return min(self._next_seq, self.capacity)

    @property
    def total_recorded(self) -> int:
        """Total rows ever written (>= ``len`` once the ring wraps)."""
        return self._next_seq

    def record(self, *, t: float, shard: int, ratio: float,
               stable_frac: float, n_known: int, n_stable: int,
               action: int, reason: int) -> int:
        """Append one controller decision row; returns its seq."""
        seq = self._next_seq
        row = self._ring[seq & (self.capacity - 1)]
        row["seq"], row["t"], row["shard"] = seq, t, shard
        row["ratio"], row["stable_frac"] = ratio, stable_frac
        row["n_known"], row["n_stable"] = n_known, n_stable
        row["action"], row["reason"] = action, reason
        self._next_seq += 1
        return seq

    def tail(self, n: int = 32) -> np.ndarray:
        """The most recent `n` rows, oldest first (a copy)."""
        n = min(n, len(self))
        if n == 0:
            return np.zeros(0, _ADAPTIVE_DTYPE)
        idx = (self._next_seq - n + np.arange(n)) & (self.capacity - 1)
        return self._ring[idx].copy()

    def explain(self, seq: int) -> AdaptiveRecord:
        """Look up one decision by sequence number (KeyError if it has
        fallen out of the ring or was never recorded)."""
        if not (0 <= seq < self._next_seq) \
                or seq < self._next_seq - self.capacity:
            raise KeyError(
                f"seq {seq} not in adaptive ring (kept: "
                f"[{max(0, self._next_seq - self.capacity)}, "
                f"{self._next_seq}))")
        return AdaptiveRecord(self._ring[seq & (self.capacity - 1)])

    def backoffs(self, n: int = 32) -> list:
        """The most recent back-off decisions (up to `n`), oldest
        first — the starting point of a "why did my budget shrink"
        investigation."""
        rows = self.tail(len(self))
        bad = rows[rows["action"] < 0]
        return [AdaptiveRecord(r) for r in bad[-n:]]
