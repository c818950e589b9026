"""Full datacenter scenario through the port, the twin of
`examples/datacenter_sim.py`:

  telemetry -> criticality algorithm -> ML predictors -> cluster
  scheduling sim -> chassis capping dynamics -> oversubscription budget

    PYTHONPATH=src python -m repro_torch.examples.datacenter_sim [--device cpu]

Labeling runs the template kernel and the chassis dynamics the torch
fleet engine on the device; the scheduling sim runs its event backend on
the host, like the original.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import features as F
from repro_torch.core.criticality import classify
from repro_torch.core.oversubscription import FleetProfile, scenario_table
from repro_torch.core.placement import SchedulerPolicy
from repro_torch.core.power_model import ServerPowerModel
from repro_torch.core.predictor import table3_metrics, train_service
from repro_torch.device import resolve_device
from repro_torch.sim.chassis_sim import paper_chassis_specs, simulate_chassis
from repro_torch.sim.scheduler_sim import (PredictionChannel, SimSpec,
                                           simulate)
from repro_torch.sim.telemetry import (generate_chassis_telemetry,
                                       generate_population)


def main(device=None) -> dict:
    """Run the scenario on `device` (the card unless ``device="cpu"``),
    print its lines, and return the numbers they print."""
    dev = resolve_device(device)

    print("=== 1. criticality + predictors (Tables II/III) ===")
    pop = generate_population(2000, seed=1)
    hist, arr = F.split_history_arrivals(pop)
    labels = classify(hist.series, device=dev).cpu().numpy()
    aggs = F.subscription_aggregates(hist, labels)
    svc = train_service(F.build_features(hist, aggs),
                        labels.astype(np.int64),
                        F.p95_bucket([v.p95_util for v in hist.vms]))
    m = table3_metrics(
        svc, F.build_features(arr, aggs),
        classify(arr.series, device=dev).cpu().numpy().astype(np.int64),
        F.p95_bucket([v.p95_util for v in arr.vms]))
    print(f"criticality acc {m['criticality']['accuracy_high_conf']:.2f}, "
          f"p95 acc {m['p95']['accuracy_high_conf']:.2f} at "
          f"{m['p95']['pct_high_conf']:.0%} high-confidence")

    print("=== 2. criticality-aware scheduling (Fig 7) ===")
    base = simulate(SchedulerPolicy(use_power_rule=False),
                    PredictionChannel("none"), SimSpec(days=6, seed=0),
                    device=dev)
    ours = simulate(SchedulerPolicy(alpha=0.8), PredictionChannel("ml"),
                    SimSpec(days=6, seed=0), device=dev)
    print(f"chassis balance std: {base.chassis_score_std:.3f} -> "
          f"{ours.chassis_score_std:.3f}; server balance std: "
          f"{base.server_score_std:.3f} -> {ours.server_score_std:.3f}")

    print("=== 3. per-VM capping under a tight chassis budget (Fig 6) ===")
    nc = simulate_chassis(paper_chassis_specs(True), None, "none", 180, 4,
                          device=dev)
    rv = simulate_chassis(paper_chassis_specs(True), 2450.0, "per_vm", 180, 4,
                          device=dev)
    latency_x = rv.uf_p95_latency / nc.uf_p95_latency
    print(f"balanced placement: UF p95 latency x{latency_x:.2f} under a "
          f"2450 W budget (batch slowdown x{rv.nuf_slowdown:.2f})")

    print("=== 4. oversubscription strategy (Table IV) ===")
    fleet = FleetProfile(beta=0.4, util_uf=0.65, util_nuf=0.44,
                         allocated_frac=0.85, servers_per_chassis=12,
                         model=ServerPowerModel())
    draws = generate_chassis_telemetry(256, 45, 3720.0, seed=0)
    rows = scenario_table(draws, 3720.0, fleet, beta_internal_only=0.54,
                          beta_non_premium=0.4225)
    sota = rows["state_of_the_art"]
    ours_row = rows["predictions_all_minimal_uf_impact"]
    print(f"state of the art: {sota.oversubscription:.1%}; with "
          f"predictions: {ours_row.oversubscription:.1%} "
          f"(x{ours_row.oversubscription/sota.oversubscription:.1f}, "
          f"paper: ~2x)")
    return {"table3": m, "sim_base": base, "sim_ours": ours,
            "uf_p95_latency_x": float(latency_x),
            "nuf_slowdown": float(rv.nuf_slowdown),
            "oversubscription": {k: float(r.oversubscription)
                                 for k, r in rows.items()}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
