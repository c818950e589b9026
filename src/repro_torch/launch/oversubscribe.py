"""Operator CLI: compute oversubscribed chassis budgets from telemetry.

The planning tool the paper's §III-E implies: feed historical chassis
draws (an .npy file or the synthetic generator), pick a scenario, get
the budget, event rates, and how many extra servers the recovered power
buys. A host-only numpy copy of `repro.launch.oversubscribe`.

  PYTHONPATH=src python -m repro_torch.launch.oversubscribe \
      --scenario predictions_minimal_uf_impact --chassis 1440 --days 90
  PYTHONPATH=src python -m repro_torch.launch.oversubscribe --draws draws.npy
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.oversubscription import (SCENARIOS, FleetProfile,
                                               compute_budget)
from repro_torch.core.power_model import P_PEAK_FMAX, ServerPowerModel


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", default=None,
                    help=".npy of chassis power readings (watts)")
    ap.add_argument("--scenario", default="predictions_minimal_uf_impact",
                    choices=sorted(SCENARIOS))
    ap.add_argument("--chassis", type=int, default=256)
    ap.add_argument("--days", type=int, default=30)
    ap.add_argument("--servers-per-chassis", type=int, default=12)
    ap.add_argument("--beta", type=float, default=0.40)
    ap.add_argument("--util-uf", type=float, default=0.65)
    ap.add_argument("--util-nuf", type=float, default=0.44)
    ap.add_argument("--allocated-frac", type=float, default=0.85)
    ap.add_argument("--campus-mw", type=float, default=128.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    provisioned = args.servers_per_chassis * P_PEAK_FMAX
    if args.draws:
        draws = np.load(args.draws)
    else:
        from repro_torch.sim.telemetry import generate_chassis_telemetry
        draws = generate_chassis_telemetry(
            args.chassis, args.days, provisioned, seed=args.seed)
        print(f"[oversubscribe] synthetic telemetry: {args.chassis} "
              f"chassis x {args.days} days")

    fleet = FleetProfile(beta=args.beta, util_uf=args.util_uf,
                         util_nuf=args.util_nuf,
                         allocated_frac=args.allocated_frac,
                         servers_per_chassis=args.servers_per_chassis,
                         model=ServerPowerModel())
    cfg = SCENARIOS[args.scenario]
    res = compute_budget(np.ravel(draws), provisioned, cfg, fleet,
                         full_server=args.scenario == "state_of_the_art")

    extra_servers = int(res.oversubscription * provisioned
                        / P_PEAK_FMAX * args.chassis)
    print(f"[oversubscribe] scenario           : {args.scenario}")
    print(f"[oversubscribe] provisioned/chassis: {provisioned:.0f} W")
    print(f"[oversubscribe] recommended budget : {res.budget_w:.0f} W "
          f"(pre-buffer {res.budget_pre_buffer_w:.0f} W)")
    print(f"[oversubscribe] oversubscription   : "
          f"{res.oversubscription:.1%}")
    print(f"[oversubscribe] UF event rate      : {res.uf_event_rate:.5f}"
          f"  (limit {cfg.emax_uf})")
    print(f"[oversubscribe] NUF event rate     : "
          f"{res.nuf_event_rate:.5f}  (limit {cfg.emax_nuf})")
    print(f"[oversubscribe] extra servers      : ~{extra_servers} "
          f"across the fleet")
    print(f"[oversubscribe] campus savings     : "
          f"${res.savings_usd(args.campus_mw)/1e6:.1f}M "
          f"({args.campus_mw:.0f} MW at $10/W)")
    return res


if __name__ == "__main__":
    main()
