"""Fault-tolerant training runtime: checkpoint/restart, failure
injection, straggler mitigation, as `repro.runtime.fault_tolerance` has
it.

At 1000+ nodes, SOME node is always failing; the loop is structured so
that every failure mode maps to 'restore newest committed checkpoint and
continue', and slow steps (stragglers) are detected against a rolling
deadline and surfaced to the power controller (the paper's capping can
CAUSE deliberate stragglers on non-critical jobs — the runtime must not
confuse throttling with failure; see power_control.py).

The reference snapshots the state before the loop as a tree of immutable
arrays. Here the snapshot is a host copy (`.to("cpu", copy=True)`): a
second copy of a full-width state does not fit on the card, and a view
of tensors a donated step writes into would rewind to the current state.
It is dropped once a checkpoint commits (a rewind reads the checkpoint
from then on) and copied back to the state's devices on a rewind. The
loop times a step on the host clock, so a `step_fn` on the card waits for
its step before it returns (`launch.train`'s reads its loss).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.checkpoint import Checkpointer
from repro_torch.tree import tree_map


@dataclass
class FaultToleranceConfig:
    """Knobs for `FaultTolerantLoop`: checkpoint cadence/retention,
    straggler detection, and the chaos-injection channel."""
    checkpoint_every: int = 50
    keep_last: int = 3
    #: a step slower than median * this factor counts as a straggler
    straggler_factor: float = 3.0
    #: consecutive straggler steps before mitigation kicks in
    straggler_patience: int = 5
    #: probability per step of an injected failure (tests/chaos)
    inject_failure_rate: float = 0.0
    max_restarts: int = 100


class InjectedFailure(RuntimeError):
    """The chaos channel: the ONLY exception the loop retries.

    Raised by the loop itself (`inject_failure_rate`) or by a test's
    step_fn to stand in for a node crash; any other exception is a
    real defect and propagates (tests/test_fault_tolerance.py)."""


@dataclass
class RunState:
    """Mutable run bookkeeping: current step, restart/mitigation
    counters, and the trailing step-time window the straggler
    deadline is computed from."""
    step: int = 0
    restarts: int = 0
    straggler_steps: int = 0
    mitigations: int = 0
    step_times: list = field(default_factory=list)
    #: host seconds the pre-loop snapshot took
    snapshot_s: float = 0.0

    def median_step_time(self) -> float:
        if not self.step_times:
            return float("inf")
        return float(np.median(self.step_times[-50:]))


class FaultTolerantLoop:
    """Drives (state, batch) -> state steps with checkpoint/restart.

    The caller provides pure functions; the loop owns persistence and
    failure handling so a node crash (or injected failure) resumes from
    the newest committed step — including after elastic re-shard.
    """

    def __init__(self, cfg: FaultToleranceConfig, checkpointer:
                 Checkpointer, rng_seed: int = 0):
        self.cfg = cfg
        self.ckpt = checkpointer
        self.state = RunState()
        self._rng = np.random.default_rng(rng_seed)
        self.on_straggler = None          # callback(state) -> None

    def resume_or_init(self, init_fn, tree_like=None, shardings=None):
        """Returns (train_state, start_step). A restored state is placed
        by `shardings` when given (`Checkpointer.restore`)."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return init_fn(), 0
        tree = tree_like if tree_like is not None else init_fn()
        restored, step = self.ckpt.restore(tree, shardings=shardings)
        return restored, step

    def run(self, train_state, step_fn, batch_fn, n_steps: int,
            start_step: int = 0):
        """step_fn(train_state, batch) -> (train_state, metrics).

        `InjectedFailure` (the chaos channel, raised by the loop
        itself or by step_fn) triggers restore-and-continue up to
        max_restarts: rewind to the newest committed checkpoint, or
        to the pre-loop snapshot if nothing committed yet. Any OTHER
        exception from step_fn/batch_fn propagates to the caller
        unchanged — a real defect must fail the job loudly, not spin
        the restore loop (pinned in tests/test_fault_tolerance.py)."""
        step = start_step
        history = []
        # snapshot for failures before the first checkpoint commits
        t0 = time.time()
        initial_state = tree_map(_host_copy, train_state)
        self.state.snapshot_s = time.time() - t0
        while step < n_steps:
            try:
                t0 = time.time()
                if (self.cfg.inject_failure_rate > 0 and
                        self._rng.random() < self.cfg.inject_failure_rate):
                    raise InjectedFailure(f"injected at step {step}")
                batch = batch_fn(step)
                train_state, metrics = step_fn(train_state, batch)
                dt = time.time() - t0
                self._track_straggler(dt)
                self.state.step_times.append(dt)
                self.state.step = step
                history.append(metrics)
                step += 1
                if step % self.cfg.checkpoint_every == 0:
                    self.ckpt.save(step, train_state)
                    initial_state = None      # rewinds read the commit
            except InjectedFailure:
                self.state.restarts += 1
                if self.state.restarts > self.cfg.max_restarts:
                    raise
                latest = self.ckpt.latest_step()
                if latest is not None:
                    train_state, step = self.ckpt.restore(train_state)
                else:
                    # failed before any commit: rewind to the snapshot
                    train_state = tree_map(_copy_back, initial_state,
                                           train_state)
                    step = start_step
        return train_state, history

    def _track_straggler(self, dt: float):
        med = self.state.median_step_time()
        if med != float("inf") and dt > self.cfg.straggler_factor * med:
            self.state.straggler_steps += 1
            if self.state.straggler_steps >= self.cfg.straggler_patience:
                self.state.mitigations += 1
                self.state.straggler_steps = 0
                if self.on_straggler is not None:
                    self.on_straggler(self.state)
        else:
            self.state.straggler_steps = 0


def _host_copy(x):
    return x.to("cpu", copy=True) if hasattr(x, "to") else x


def _copy_back(snap, like):
    return snap.to(like.device, copy=True) if hasattr(snap, "to") else snap
