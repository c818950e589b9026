"""The port's §V prioritized throttling list (`repro_torch.core.priority`,
a host copy over the port's power model) against the JAX package's, on
the CPU: the reference's behaviour checks run against the port, and a
shared run of both controllers keeps every VM's frequency, kill state and
the power each step reports equal."""
import numpy as np
import pytest

from repro.core import power_model as RPM
from repro.core import priority as RP
from repro_torch.core.power_model import F_MAX, F_MIN, ServerPowerModel
from repro_torch.core.priority import PrioritizedVM, Tier, TieredController

UTILS = {"spot": 1.0, "internal-batch": 1.0, "ext-batch": 1.0,
         "frontend": 0.7}


def make_controller(budget=240.0, enable_kill=True, mod=None):
    if mod is None:
        c = TieredController(ServerPowerModel(), budget,
                             enable_kill=enable_kill)
        vm, tier = PrioritizedVM, Tier
    else:
        c = mod.TieredController(RPM.ServerPowerModel(), budget,
                                 enable_kill=enable_kill)
        vm, tier = mod.PrioritizedVM, mod.Tier
    c.register(vm("spot", 8, tier.LOW_PRIORITY, kill_preferred=True))
    c.register(vm("internal-batch", 10, tier.INTERNAL_NUF))
    c.register(vm("ext-batch", 10, tier.EXTERNAL_NUF))
    c.register(vm("frontend", 12, tier.USER_FACING))
    return c


def test_throttling_order_follows_tiers():
    c = make_controller(budget=260.0, enable_kill=False)
    for _ in range(60):
        c.step(UTILS)
    vms = {v.name: v for v in c.vms}
    assert vms["spot"].freq <= vms["internal-batch"].freq
    assert vms["internal-batch"].freq <= vms["ext-batch"].freq
    assert vms["frontend"].freq == F_MAX


def test_budget_enforced():
    c = make_controller(budget=240.0, enable_kill=False)
    for _ in range(200):
        out = c.step(UTILS)
    assert out["power_w"] <= 240.0 + 1e-6


def test_kill_preferred_vm_shed_before_throttling_tier():
    c = TieredController(ServerPowerModel(), 220.0)
    c.register(PrioritizedVM("shreddable", 10, Tier.LOW_PRIORITY,
                             kill_preferred=True))
    c.register(PrioritizedVM("batch", 20, Tier.INTERNAL_NUF))
    c.register(PrioritizedVM("frontend", 10, Tier.USER_FACING))
    out = c.step({"shreddable": 1.0, "batch": 1.0, "frontend": 0.8})
    assert "shreddable" in out["killed"]
    assert not {v.name: v for v in c.vms}["shreddable"].alive


def test_recovery_raises_highest_tier_first():
    c = make_controller(budget=250.0, enable_kill=False)
    for _ in range(80):
        c.step(UTILS)
    for _ in range(3):
        c.step({k: 0.15 for k in UTILS})
    vms = {v.name: v for v in c.vms}
    assert vms["ext-batch"].freq >= vms["spot"].freq


def test_impact_report_structure():
    c = make_controller()
    c.step(UTILS)
    rep = c.impact_report()
    assert set(rep) == set(UTILS)
    for v in rep.values():
        assert F_MIN <= v["freq"] <= F_MAX


@pytest.mark.parametrize("enable_kill", [False, True])
@pytest.mark.parametrize("budget", [220.0, 250.0, 280.0])
def test_controller_matches_reference(budget, enable_kill):
    """Seeded load swings (overload, recovery, overload): every step's
    report and impact report equal the reference controller's."""
    rng = np.random.default_rng(int(budget))
    port = make_controller(budget, enable_kill)
    ref = make_controller(budget, enable_kill, mod=RP)
    for k in range(120):
        scale = 1.0 if (k // 30) % 2 == 0 else 0.2
        utils = {n: float(min(1.0, scale * rng.uniform(0.6, 1.2)))
                 for n in UTILS}
        assert port.step(utils) == ref.step(utils), k
        assert port.impact_report() == ref.impact_report(), k
