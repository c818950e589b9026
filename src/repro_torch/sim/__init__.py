"""Datacenter simulation substrate: workload/telemetry generation (numpy,
carried over from `repro.sim`), the cluster scheduler simulation, and
the chassis power dynamics of the fleet engine.

Front door: build a :class:`SimSpec` and hand it to :func:`simulate`;
its ``emergency``, ``ballooning`` and ``adaptive`` fields take the
planes' configs (`repro_torch.serve.EmergencyConfig`,
`BallooningConfig`, `AdaptiveConfig`).
"""
from repro_torch.sim.scheduler_sim import (GB_PER_CORE, PowerEvalSpec,
                                           PredictionChannel,
                                           ServeBackendSpec, SimMetrics,
                                           SimSpec, evaluate_power_dynamics,
                                           fig7_sweep, simulate)

__all__ = [
    "GB_PER_CORE", "PowerEvalSpec", "PredictionChannel",
    "ServeBackendSpec", "SimMetrics", "SimSpec",
    "evaluate_power_dynamics", "fig7_sweep", "simulate",
]
