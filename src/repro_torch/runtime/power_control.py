"""Power-control integration: the paper's per-VM capping controller
governing training/serving jobs (the 'VMs' of this framework), the
counterpart of `repro.runtime.power_control`.

Each job registers with a ChassisPowerSim carrying its predicted
criticality tag (from core.predictor) and utilization. The sim:

  * reports job power to the chassis model (core.power_model) from the
    measured step-time duty cycle;
  * applies frequency caps from the per-VM controller when the chassis
    manager raises an alert;
  * maps the DVFS frequency to a throughput multiplier: the training
    loop sleeps (1/f - 1) x step_time, exactly how a p-state cap
    manifests to a compute-bound job.

Criticality-aware semantics from the paper: user-facing (serving) jobs
are in the high-priority core group and are never throttled by the
in-band path; batch (training) jobs absorb the frequency cuts; RAPL
remains the hardware backstop.

The control step is the same `core.fleet_dynamics.fleet_step` the fleet
engine loops over, on the simulator's device (``backend="torch"``, the
card unless ``device`` says otherwise); ``backend="numpy"`` runs the
numpy oracle instead.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.capping import ChassisManager, ServerCapState
from repro_torch.core.fleet_dynamics import (ALERT_FRACTION, ALERT_MARGIN_W,
                                             ControlParams, FleetState,
                                             RunParams, fleet_step,
                                             fleet_step_np)
from repro_torch.core.power_model import F_MAX, N_PSTATES, ServerPowerModel
from repro_torch.device import resolve_device


@dataclass
class JobSpec:
    name: str
    cores: int
    user_facing: bool                  # prediction from core.predictor
    p95_util: float                    # predicted bucket midpoint


@dataclass
class ChassisPowerSim:
    """One simulated chassis hosting framework jobs on its servers.
    `backend`: 'torch' (the step on `device`; None means the card and
    raises without one) or 'numpy' (the oracle on the host)."""
    budget_w: float
    model: ServerPowerModel = field(default_factory=ServerPowerModel)
    jobs: list = field(default_factory=list)
    backend: str = "torch"
    device: object = None

    def __post_init__(self):
        if self.backend not in ("torch", "numpy"):
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             "'torch' or 'numpy'")
        self._dev = resolve_device(self.device) \
            if self.backend == "torch" else None
        self.state = None
        self.manager = ChassisManager(self.budget_w)
        # the framework integration trips RAPL exactly at the budget and
        # does not keep polling it through the restore phase (the seed's
        # semantics), unlike the chassis simulator
        self._cp = ControlParams.from_model(
            self.model, mode="per_vm", psu_trip_margin_w=0.0,
            rapl_continuation=False)
        self._rp = None

    def register(self, job: JobSpec):
        self.jobs.append(job)
        n_cores = sum(j.cores for j in self.jobs)
        uf_mask = np.concatenate([
            np.full(j.cores, j.user_facing) for j in self.jobs])
        self.state = ServerCapState(n_cores, uf_mask)
        rp = RunParams(
            server_budget_w=np.float32(self.budget_w),
            target_w=np.float32(self.budget_w - ALERT_MARGIN_W),
            alert_w=np.float32(self.budget_w * ALERT_FRACTION),
            min_pstate=np.int32(N_PSTATES - 1),
            uf_mask=np.asarray(uf_mask, bool).reshape(1, -1),
            active=None)
        self._rp = rp if self._dev is None else RunParams(
            *(torch.as_tensor(x, device=self._dev) for x in rp[:5]), None)

    def job_slice(self, name: str) -> slice:
        start = 0
        for j in self.jobs:
            if j.name == name:
                return slice(start, start + j.cores)
            start += j.cores
        raise KeyError(name)

    def step(self, utils: np.ndarray) -> dict:
        """One 200 ms control step; utils = per-core utilization."""
        util = np.asarray(utils, np.float32).reshape(1, -1)
        st = self.state._pack()
        if self._dev is None:
            st2, outs = fleet_step_np(self._cp, self._rp, st, util)
        else:
            st2, outs = fleet_step(
                self._cp, self._rp,
                FleetState(*(torch.as_tensor(x, device=self._dev)
                             for x in st)),
                torch.as_tensor(util, device=self._dev))
            st2 = FleetState(*(x.cpu().numpy() for x in st2))
        self.state._unpack(st2)
        return {"power_w": float(outs.chassis_power_w),
                "alert": bool(outs.alert),
                "freq": self.state.freq.copy()}

    def job_frequency(self, name: str) -> float:
        return float(self.state.freq[self.job_slice(name)].mean())


class ThrottledLoop:
    """Wraps a training step with the DVFS-cap duty cycle: at frequency
    f the job runs at f x nominal throughput, i.e. each step stretches
    by 1/f. (On real hardware the p-state does this in silicon; here the
    effect is made visible to wall-clock metrics.)"""

    def __init__(self, chassis: ChassisPowerSim, job: str,
                 utilization: float = 1.0):
        self.chassis = chassis
        self.job = job
        self.utilization = utilization

    def run_step(self, fn, *args):
        t0 = time.time()
        out = fn(*args)
        dt = time.time() - t0
        utils = np.zeros(self.chassis.state.n_cores)
        for j in self.chassis.jobs:
            utils[self.chassis.job_slice(j.name)] = \
                self.utilization if j.name == self.job else j.p95_util
        self.chassis.step(utils)
        f = self.chassis.job_frequency(self.job)
        if f < F_MAX:
            time.sleep(dt * (F_MAX / f - 1.0))
        return out, {"freq": f, "step_s": dt}
