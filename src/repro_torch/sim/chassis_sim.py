"""Chassis/server power-capping dynamics (paper §IV-C, §IV-D; Figs 4-6),
the counterpart of `repro.sim.chassis_sim`.

A 200 ms-step simulator of the paper's testbed: 12-blade chassis, 40-core
blades (2x20), the per-VM controller + chassis manager + RAPL backup of
`core.fleet_dynamics`, and two instrumented applications:

  * UF app — latency-critical transaction processing: open-loop arrivals
    into a fluid queue whose service capacity is the sum of its cores'
    frequencies; reports p95 latency (normalized to no-cap).
  * NUF app — batch (Terasort-like): saturates its cores; total work is
    fixed, so its metric is the completion slowdown.

A thin adapter over the fleet engine (`sim.fleet`): Figs 4-6 are slices
of one fleet run. The reference defaults these entry points to its numpy
oracle; here they run the torch engine on the card unless the caller
passes ``backend="numpy"`` or ``device="cpu"``, like every entry point of
the port.
"""
from __future__ import annotations

from repro_torch.core.power_model import ServerPowerModel
from repro_torch.sim.fleet import (FleetResult, ServerSpec, SimResult, VMSpec,
                                   _uf_load_trace, run_fleet)

__all__ = ["VMSpec", "ServerSpec", "SimResult", "simulate_server",
           "simulate_chassis", "paper_single_server_spec",
           "paper_chassis_specs", "_uf_load_trace"]


def simulate_server(spec: ServerSpec, budget_w: float | None,
                    mode: str, duration_s: float = 600.0,
                    seed: int = 0,
                    model: ServerPowerModel | None = None,
                    backend: str = "torch", device=None) -> SimResult:
    """One server under a power cap. mode: 'none' | 'rapl' | 'per_vm'."""
    return simulate_chassis([spec], budget_w, mode, duration_s, seed,
                            model, backend, device)


def simulate_chassis(specs: list, budget_w: float | None, mode: str,
                     duration_s: float = 600.0, seed: int = 0,
                     model: ServerPowerModel | None = None,
                     backend: str = "torch", device=None) -> SimResult:
    """Simulate a chassis of servers under a shared chassis budget.

    mode 'per_vm' runs the full paper stack: chassis-manager alerts ->
    per-VM controllers -> RAPL only as backup. mode 'rapl' is the
    existing full-server mechanism (PSU -> BMC -> RAPL, all cores
    equally). mode 'none' = uncapped. `backend` 'torch' runs on
    `device` (None: the card, raising without one); 'numpy' runs the
    oracle on the host.
    """
    res: FleetResult = run_fleet(specs, budget_w, mode, duration_s,
                                 seed, model, backend=backend, device=device)
    return res.chassis(0)


# --- canonical experiment setups -------------------------------------------

def paper_single_server_spec() -> ServerSpec:
    """§IV-C: one UF VM (20 vcores) + one NUF VM (20 vcores).

    UF offered load 0.58 of capacity: hot enough that a 210 W cap cannot
    be met by NUF throttling alone (RAPL backup engages, as in the
    paper), while 230 W can (UF protected)."""
    return ServerSpec(vms=[VMSpec(20, True, load=0.58),
                           VMSpec(20, False)])


def paper_chassis_specs(balanced: bool) -> list:
    """§IV-D: 12 servers, 36 UF VMs (4 cores) + 36 NUF VMs (6 cores).

    balanced: 3 UF + 3 NUF VMs round-robin per server.
    imbalanced: 6 servers with 6 UF VMs each, 6 servers with 6 NUF each.
    """
    if balanced:
        return [ServerSpec(vms=[VMSpec(4, True, load=0.85)] * 3
                           + [VMSpec(6, False)] * 3) for _ in range(12)]
    uf_servers = [ServerSpec(vms=[VMSpec(4, True, load=0.85)] * 6)
                  for _ in range(6)]
    nuf_servers = [ServerSpec(vms=[VMSpec(6, False)] * 6)
                   for _ in range(6)]
    return uf_servers + nuf_servers
