"""Production-deployment lessons from paper §V, a host copy of
`repro.core.priority` over the port's power model:

* **Prioritized throttling list** — "we first consider low priority and
  internal non-production VMs for throttling and throttle production
  (including third-party, if configured) non-user-facing VMs as a last
  resort": the controller walks priority tiers instead of treating all
  NUF cores as one pool.
* **Killing VMs** — "some first-party customers ... prefer their VMs to
  be killed rather than throttled": kill-tagged VMs are shed entirely
  (their cores drop to zero utilization) when throttling the tiers
  below them is insufficient.
* **Per-VM frequency (no core pinning)** — production Azure could not
  restrict a VM to a core subset; the hypervisor carries a per-VM
  frequency to whichever cores it schedules on. We model that by
  tracking frequency per VM and projecting onto the VM's scheduled
  cores each quantum (frequencies change in tens of microseconds vs the
  10 ms quantum, so the projection is exact at our 200 ms step).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from repro_torch.core.power_model import (F_MAX, F_MIN, N_PSTATES,
                                          ServerPowerModel, dyn_scale,
                                          idle_power, pstate_frequencies)


class Tier(IntEnum):
    """Throttling order: lower tiers are throttled first (paper §V)."""
    LOW_PRIORITY = 0            # internal non-production, spot
    INTERNAL_NUF = 1            # internal production batch
    EXTERNAL_NUF = 2            # third-party non-user-facing (if configured)
    USER_FACING = 3             # never throttled in-band


@dataclass
class PrioritizedVM:
    name: str
    cores: int
    tier: Tier
    kill_preferred: bool = False      # §V: kill instead of throttle
    freq: float = F_MAX               # per-VM frequency (no core pinning)
    alive: bool = True


@dataclass
class TieredController:
    """Per-VM controller with the §V prioritized throttling list.

    step(): given per-VM utilization, enforce the budget by walking
    tiers LOW_PRIORITY -> EXTERNAL_NUF: within a tier, first kill the
    kill-preferred VMs (if enabled), then lower the remaining VMs'
    frequency one p-state per poll. USER_FACING is only touched by the
    out-of-band RAPL model (not here).
    """
    model: ServerPowerModel
    budget_w: float
    enable_kill: bool = True
    vms: list = field(default_factory=list)
    target_margin_w: float = 5.0

    def register(self, vm: PrioritizedVM):
        self.vms.append(vm)

    def power(self, utils: dict) -> float:
        dyn = 0.0
        f_sum, n = 0.0, 0
        for vm in self.vms:
            u = utils.get(vm.name, 0.0) if vm.alive else 0.0
            dyn += vm.cores * u * self.model.p_dyn_per_core \
                * _dyn_scale(vm.freq)
            f_sum += vm.freq * vm.cores
            n += vm.cores
        return float(idle_power(f_sum / max(n, 1)) + dyn)

    def step(self, utils: dict) -> dict:
        """One 200 ms control step. Returns {power, killed, throttled}."""
        target = self.budget_w - self.target_margin_w
        killed, throttled = [], []
        power = self.power(utils)
        if power > target:
            for tier in (Tier.LOW_PRIORITY, Tier.INTERNAL_NUF,
                         Tier.EXTERNAL_NUF):
                tier_vms = [v for v in self.vms
                            if v.tier == tier and v.alive]
                # 1) kill-preferred VMs shed first within the tier
                if self.enable_kill:
                    for vm in tier_vms:
                        if power <= target:
                            break
                        if vm.kill_preferred:
                            vm.alive = False
                            killed.append(vm.name)
                            power = self.power(utils)
                # 2) throttle the rest one p-state
                for vm in tier_vms:
                    if power <= target:
                        break
                    if vm.alive and vm.freq > F_MIN:
                        vm.freq = _next_pstate_down(vm.freq)
                        throttled.append(vm.name)
                        power = self.power(utils)
                if power <= target:
                    break
        else:
            # recover: raise the HIGHEST tier first (least important
            # VMs stay throttled longest)
            for tier in (Tier.EXTERNAL_NUF, Tier.INTERNAL_NUF,
                         Tier.LOW_PRIORITY):
                for vm in self.vms:
                    if vm.tier != tier or not vm.alive:
                        continue
                    if vm.freq < F_MAX:
                        trial = _next_pstate_up(vm.freq)
                        old = vm.freq
                        vm.freq = trial
                        if self.power(utils) > target:
                            vm.freq = old
        return {"power_w": self.power(utils), "killed": killed,
                "throttled": throttled}

    def impact_report(self) -> dict:
        """§V 'metrics to measure impact': how long/hard VMs are capped
        is tracked by the caller per step; this reports current state."""
        return {vm.name: {"tier": int(vm.tier), "freq": vm.freq,
                          "alive": vm.alive} for vm in self.vms}


def _dyn_scale(f: float) -> float:
    return float(dyn_scale(f))


_TABLE = pstate_frequencies(N_PSTATES)


def _next_pstate_down(f: float) -> float:
    lower = _TABLE[_TABLE < f - 1e-9]
    return float(lower[0]) if len(lower) else F_MIN


def _next_pstate_up(f: float) -> float:
    higher = _TABLE[::-1]
    higher = higher[higher > f + 1e-9]
    return float(higher[0]) if len(higher) else F_MAX
