"""Port placement (`repro_torch.serve.placement`, direct rank form)
against its oracles, on the CPU.

- float64: every decision equals `SchedulerPolicy.choose` +
  `ClusterState.place` stepped one arrival at a time (the numpy oracle
  carried into the port, array-equal to `repro.core.placement`), rank
  ties included, and the aggregates match exactly.
- float32: the served `servers` equal the JAX `place_batch` under a
  chassis watt budget that produces FAIL_POWER.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.core.placement import ClusterState, SchedulerPolicy
from repro_torch.serve import admission, placement as P


def _fresh(n_servers, per_chassis, cores):
    return ClusterState(
        n_servers=n_servers, cores_per_server=cores,
        chassis_of_server=np.arange(n_servers) // per_chassis,
        n_chassis=n_servers // per_chassis)


def _oracle_round(st, policy, cores, is_uf, p95):
    want = []
    for i in range(len(cores)):
        s = policy.choose(st, int(cores[i]), bool(is_uf[i]))
        want.append(P.FAIL_CAPACITY if s is None else s)
        if s is not None:
            st.place(s, int(cores[i]), float(p95[i]), bool(is_uf[i]))
    return want


def _port_round(dst, policy, cores, is_uf, p95, st):
    dst, srvs = P.place_batch(dst, cores, is_uf, p95,
                              np.ones(len(cores), bool),
                              np.full(st.n_chassis, np.inf), policy,
                              st.cores_per_server)
    return dst, srvs.tolist()


def _assert_state_equal(dst, st):
    np.testing.assert_array_equal(dst.free_cores.numpy(), st.free_cores)
    np.testing.assert_array_equal(dst.gamma_uf.numpy(), st.gamma_uf)
    np.testing.assert_array_equal(dst.gamma_nuf.numpy(), st.gamma_nuf)
    np.testing.assert_array_equal(dst.rho_peak.numpy(), st.rho_peak)


POLICIES = [SchedulerPolicy(alpha=0.8), SchedulerPolicy(alpha=0.5),
            SchedulerPolicy(packing_weight=0.0),
            SchedulerPolicy(use_power_rule=False)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", POLICIES, ids=["a08", "a05", "power",
                                                  "pack"])
def test_float64_decisions_equal_oracle(seed, policy):
    """Rounds of place / depart / re-arrive: every decision and the final
    aggregates equal the sequential oracle's."""
    rng = np.random.default_rng(seed)
    st = _fresh(36, 12, 40)
    dst = P.device_state(copy.deepcopy(st), torch.float64, "cpu")
    placed, migrants = [], []
    for _ in range(4):
        n_new = 24 - len(migrants)
        cores = np.concatenate([[m[1] for m in migrants],
                                rng.choice([1, 2, 4, 8, 16], n_new)])
        is_uf = np.concatenate([[m[3] for m in migrants],
                                rng.random(n_new) < 0.5]).astype(bool)
        p95 = np.concatenate([[m[2] for m in migrants],
                              rng.uniform(0.05, 1.0, n_new)])
        want = _oracle_round(st, policy, cores, is_uf, p95)
        dst, got = _port_round(dst, policy, cores, is_uf, p95, st)
        assert got == want
        placed += [(s, cores[i], p95[i], is_uf[i])
                   for i, s in enumerate(want) if s >= 0]
        pick = set(rng.choice(len(placed), size=len(placed) // 3,
                              replace=False).tolist())
        dep = [placed[j] for j in sorted(pick)]
        placed = [p for j, p in enumerate(placed) if j not in pick]
        migrants = dep[: len(dep) // 2]
        for s, c, p, u in dep:
            st.remove(int(s), int(c), float(p), bool(u))
        dst = P.remove_batch(dst, [d[0] for d in dep], [d[1] for d in dep],
                             [d[2] for d in dep], [bool(d[3]) for d in dep])
        _assert_state_equal(dst, st)


def test_float64_rank_ties_identical_arrivals():
    """An empty cluster and identical arrivals tie every key: ties must
    break as the oracle's stable argsort breaks them."""
    policy = SchedulerPolicy(alpha=0.8)
    st = _fresh(24, 4, 40)
    dst = P.device_state(copy.deepcopy(st), torch.float64, "cpu")
    cores, p95 = np.full(16, 2.0), np.full(16, 0.5)
    for is_uf in (np.ones(16, bool), np.arange(16) % 2 == 0):
        want = _oracle_round(st, policy, cores, is_uf, p95)
        dst, got = _port_round(dst, policy, cores, is_uf, p95, st)
        assert got == want
    _assert_state_equal(dst, st)


def test_full_cluster_fails_then_reopens():
    policy = SchedulerPolicy(alpha=0.8)
    st = _fresh(4, 2, 8)
    dst = P.device_state(copy.deepcopy(st), torch.float64, "cpu")
    cores, is_uf = np.full(6, 8.0), np.arange(6) % 2 == 0
    want = _oracle_round(st, policy, cores, is_uf, np.full(6, 0.6))
    dst, got = _port_round(dst, policy, cores, is_uf, np.full(6, 0.6), st)
    assert got == want and want[4:] == [P.FAIL_CAPACITY] * 2
    for s in (want[1], want[2]):
        st.remove(int(s), 8, 0.6, bool(is_uf[want.index(s)]))
    dst = P.remove_batch(dst, [want[1], want[2]], [8.0, 8.0], [0.6, 0.6],
                         [is_uf[1], is_uf[2]])
    cores2, uf2 = np.array([4.0, 4.0, 8.0, 8.0]), np.array([1, 1, 0, 0], bool)
    p2 = np.array([0.3, 0.9, 0.5, 0.5])
    assert _port_round(dst, policy, cores2, uf2, p2, st)[1] == \
        _oracle_round(st, policy, cores2, uf2, p2)


def test_float64_place_remove_roundtrip_exact():
    """Placing a batch and removing it again lands exactly where the
    oracle's place-then-remove in the same order lands; the cores come
    back exactly."""
    rng = np.random.default_rng(5)
    st = _fresh(12, 4, 40)
    dst0 = P.device_state(copy.deepcopy(st), torch.float64, "cpu")
    cores = rng.choice([1, 2, 4], 20).astype(float)
    is_uf, p95 = rng.random(20) < 0.5, rng.uniform(0.05, 1.0, 20)
    dst, srv = P.place_batch(dst0, cores, is_uf, p95, np.ones(20, bool),
                             np.full(3, np.inf), SchedulerPolicy(), 40)
    want = _oracle_round(st, SchedulerPolicy(), cores, is_uf, p95)
    assert srv.tolist() == want
    for s, c, p, u in zip(want, cores, p95, is_uf):
        st.remove(s, int(c), float(p), bool(u))
    back = P.remove_batch(dst, srv, cores, p95, is_uf)
    _assert_state_equal(back, st)
    np.testing.assert_array_equal(back.free_cores.numpy(),
                                  dst0.free_cores.numpy())
    np.testing.assert_array_equal(back.res_peak[:, 1].numpy(), 0.0)


def test_padding_rows_never_touch_state():
    st = _fresh(12, 4, 40)
    dst0 = P.device_state(st, torch.float32, "cpu")
    valid = np.array([True, False, True, False])
    dst, srv = P.place_batch(dst0, np.full(4, 4.0), valid, np.full(4, 0.5),
                             valid, np.full(3, np.inf), SchedulerPolicy(), 40)
    counts = P.outcome_counters(srv.numpy(), valid, np.full(4, 4.0),
                                np.full(4, 0.5))
    assert counts["admits"] == 2 and sum(
        counts[k] for k in ("admits", "fail_capacity", "fail_power",
                            "fail_tokens")) == valid.sum()
    assert float(dst.free_cores.sum()) == 12 * 40 - 8


@pytest.fixture(scope="module")
def rserve():
    pytest.importorskip("jax")
    from _torch_parity import reference_serve
    return reference_serve()


def test_scores_match_oracle():
    rng = np.random.default_rng(2)
    st = _fresh(12, 4, 40)
    for _ in range(30):
        s = int(rng.integers(0, 12))
        if st.free_cores[s] >= 4:
            st.place(s, 4, float(rng.uniform(0, 1)), bool(rng.random() < .5))
    dst = P.device_state(st, torch.float64, "cpu")
    np.testing.assert_array_equal(P.score_chassis_batch(dst).numpy(),
                                  st.score_chassis())
    for uf in (True, False):
        np.testing.assert_array_equal(
            P.score_server_batch(dst, uf, 40).numpy(), st.score_server(uf))
    both = P.score_server_batch(dst, torch.tensor([True, False]), 40)
    np.testing.assert_array_equal(both[1].numpy(), st.score_server(False))


@pytest.mark.parametrize("seed,joint", [(0, False), (1, False), (2, True)])
def test_float32_servers_equal_jax_under_power_budget(rserve, seed, joint):
    """Under a chassis watt budget (and, `joint`, a cores ceiling too) the
    served decisions, FAIL_POWER included, equal the JAX scan's."""
    import jax.numpy as jnp
    from repro.core.placement import SchedulerPolicy as RPolicy
    from repro.core.resources import ResourceVector as RVector
    from repro_torch.core.resources import ResourceVector
    rng = np.random.default_rng(seed)
    n, per, cps = 36, 12, 40
    chassis = np.arange(n) // per
    budget_w = 12 * 112.0 + 150.0 * 4.95             # rho ceiling ~150
    cores_cap = 300.0 if joint else None
    caps = cap = admission.resource_caps_from_budget(
        ResourceVector(watts=budget_w, cores=cores_cap), per, n // per)
    np.testing.assert_array_equal(caps, rserve.resource_caps_from_budget(
        RVector(watts=budget_w, cores=cores_cap), per, n // per))
    if not joint:                        # the legacy (C,) watt-axis form
        cap = admission.rho_cap_from_budget(budget_w, per, n // per)
        np.testing.assert_array_equal(
            cap, rserve.rho_cap_from_budget(budget_w, per, n // per))
    j_state = rserve.fresh_state(n, cps, chassis)
    p_state = P.fresh_state(n, cps, chassis, device="cpu")
    fails = 0
    for _ in range(3):
        b = 64
        cores = rng.choice([1, 2, 4, 8, 16], b).astype(np.float32)
        is_uf = rng.random(b) < 0.5
        p95 = ((rng.integers(0, 4, b) * 25.0 + 12.5) / 100.0) \
            .astype(np.float32)
        mem = (cores * 4).astype(np.float32)
        valid = np.arange(b) < b - 3
        j_state, j_srv = rserve.place_batch(
            j_state, jnp.asarray(cores), jnp.asarray(is_uf),
            jnp.asarray(p95), jnp.asarray(valid), jnp.asarray(cap),
            RPolicy(), cps, mem_gb=jnp.asarray(mem))
        p_state, p_srv = P.place_batch(p_state, cores, is_uf, p95, valid,
                                       cap, SchedulerPolicy(), cps,
                                       mem_gb=mem)
        np.testing.assert_array_equal(p_srv.numpy()[valid],
                                      np.asarray(j_srv)[valid])
        fails += int((p_srv.numpy()[valid] == P.FAIL_POWER).sum())
    assert fails > 0
    np.testing.assert_array_equal(p_state.res_peak.numpy(),
                                  np.asarray(j_state.res_peak))
    assert (p_state.res_peak.numpy() <= caps).all()
    np.testing.assert_array_equal(
        admission.headroom_w(p_state, budget_w, per),
        rserve.headroom_w(j_state, budget_w, per))
