"""Quickstart: the paper's prediction pipeline through the port, the twin
of `examples/quickstart.py`.

Generates a VM population, labels it with the criticality algorithm (the
template kernel on the card), trains the Random-Forest predictors,
places arrivals with Algorithm 1, computes the oversubscribed chassis
budget, and serves an arrival stream through `ServePipeline` (the forest
kernel on the card).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import features as F
from repro_torch.core.criticality import classify
from repro_torch.core.oversubscription import (SCENARIOS, FleetProfile,
                                               compute_budget)
from repro_torch.core.placement import ClusterState, SchedulerPolicy
from repro_torch.core.power_model import ServerPowerModel
from repro_torch.core.predictor import bucket_to_p95, train_service
from repro_torch.device import resolve_device
from repro_torch.serve import ServePipeline
from repro_torch.sim.telemetry import (arrival_batch,
                                       generate_chassis_telemetry,
                                       generate_population)


def main(device=None) -> dict:
    """Run the quickstart on `device` (the card unless ``device="cpu"``),
    print its lines, and return the numbers they print."""
    dev = resolve_device(device)

    # 1 — label history with the criticality algorithm (paper §III-B)
    pop = generate_population(1200, seed=0)
    hist, arrivals = F.split_history_arrivals(pop)
    labels = classify(hist.series, device=dev).cpu().numpy()
    print(f"history: {len(hist.vms)} VMs, {labels.mean():.0%} user-facing")

    # 2 — train the prediction service (paper §III-B, Table III)
    aggs = F.subscription_aggregates(hist, labels)
    svc = train_service(F.build_features(hist, aggs),
                        labels.astype(np.int64),
                        F.p95_bucket([v.p95_util for v in hist.vms]))

    # 3 — place arrivals with criticality-aware Algorithm 1 (paper §III-C)
    preds = svc.query(F.build_features(arrivals, aggs))
    state = ClusterState(n_servers=36, cores_per_server=40,
                         chassis_of_server=np.arange(36) // 12, n_chassis=3)
    policy = SchedulerPolicy(alpha=0.8)
    for i, vm in enumerate(arrivals.vms[:150]):
        uf = bool(preds["workload_type_used"][i])
        srv = policy.choose(state, vm.cores, uf)
        if srv is not None:
            state.place(srv, vm.cores,
                        float(bucket_to_p95(preds["p95_bucket_used"][i])), uf)
    chassis_std = float(np.std(state.score_chassis()))
    print(f"placed 150 VMs; chassis balance std = {chassis_std:.3f}")

    # 4 — oversubscribe the chassis budget (paper §III-E, Table IV)
    fleet = FleetProfile(beta=0.4, util_uf=0.65, util_nuf=0.44,
                         allocated_frac=0.85, servers_per_chassis=12,
                         model=ServerPowerModel())
    draws = generate_chassis_telemetry(64, 30, 3720.0, seed=0)
    res = compute_budget(draws.ravel(), 3720.0,
                         SCENARIOS["predictions_minimal_uf_impact"], fleet)
    print(f"oversubscription: {res.oversubscription:.1%} "
          f"(${res.savings_usd()/1e6:.0f}M on a 128 MW campus)")

    # 5 — serve an arrival stream through the online pipeline
    pipe = ServePipeline.from_history(svc, hist, labels, n_servers=36,
                                      cores_per_server=40,
                                      blades_per_chassis=12, device=dev)
    served = pipe.serve(arrival_batch(generate_population(256, seed=7)))
    print(f"served 256 arrivals: {served.n_admitted} admitted, "
          f"{served.n_conservative} conservative fallbacks")
    return {"history": len(hist.vms), "uf_share": float(labels.mean()),
            "chassis_std": chassis_std,
            "oversubscription": float(res.oversubscription),
            "savings_usd": float(res.savings_usd()),
            "admitted": served.n_admitted,
            "conservative": served.n_conservative}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
