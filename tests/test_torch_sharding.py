"""The port's sharded reserve/commit protocol (`repro_torch.serve.sharding`)
and its pooled walk (`serve.placement`) against the JAX package's
`repro.serve.sharding`, on the CPU, at 48 servers in chassis of 4 to 12.

- The host helpers (routing, round packing, cap and departure splits,
  budget -> pool) are array-equal to the reference's.
- `shard_state`/`unshard_state` leaves equal the reference's at 1 to 4
  shards.
- `place_group_sharded` in float64 gives the reference's servers, info,
  shard states and pools bit for bit, over the four policies of the
  reference's tests and 1 to 4 shards (3 shards of 12 chassis divide the
  pool by 3, where the order of a division shows), with a tiny pool
  (FAIL_TOKENS), with shard 0 full (spillover), and with one feasible
  server fleet-wide. In float32 the decisions equal and the pools are
  bit-equal too.
- One shard decides as the port's `place_batch`, final state included.
- The fused home round equals the reference's and W standalone
  `apply_caps_sharded` calls; `remove_sharded` round-trips; the sharded
  emergency, balloon and adaptive steps decide as the reference's per
  shard, their float fields within rounding of it (the reference sums a
  chassis' blades in XLA's order), and the emergency and balloon states
  are bit-equal to the port's unsharded steps.
- The mesh leg (one shard a position of `shard_mesh(n, devices=("cpu",)
  * n)`, n 2 and 4, or 3 for the planes) runs the cases above that name
  it: its servers, info, states, pools and plane outputs are bit-equal to
  the batch-axis leg's on the same inputs, and so held to the reference
  as that leg is. `spill_rounds` 0, 1 and None and `rebalance=False` give
  the reference's servers, info and states on both legs.

The reference's `tests/test_serve_sharded.py` fails collection on the
installed jax, so its module comes through `_torch_parity.reference_serve`.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import reference_serve  # noqa: E402
from repro.core.placement import ClusterState  # noqa: E402
from repro.core.placement import SchedulerPolicy as RPolicy  # noqa: E402
from repro_torch.core.placement import SchedulerPolicy  # noqa: E402
from repro_torch.core.resources import ResourceVector  # noqa: E402
from repro_torch.serve import adaptive as A  # noqa: E402
from repro_torch.serve import ballooning as B  # noqa: E402
from repro_torch.serve import emergency as E  # noqa: E402
from repro_torch.serve import placement as P  # noqa: E402
from repro_torch.serve import sharding as S  # noqa: E402

POLICIES = [dict(alpha=0.8), dict(alpha=0.0),
            dict(alpha=0.8, packing_weight=0.0),
            dict(use_power_rule=False)]
POLICY_IDS = ["a08", "a00", "power_only", "packing_only"]
SHARDS = [1, 2, 3, 4]


@pytest.fixture(scope="module")
def rs():
    return reference_serve("sharding")


@pytest.fixture(scope="module")
def rp():
    return reference_serve("placement")


def _loaded(seed, n_servers=48, per_chassis=4, n=120):
    """The reference tests' cluster: random VMs on a fleet of 40-core
    servers."""
    rng = np.random.default_rng(seed)
    st = ClusterState(n_servers=n_servers, cores_per_server=40,
                      chassis_of_server=np.arange(n_servers) // per_chassis,
                      n_chassis=n_servers // per_chassis)
    for _ in range(n):
        srv = int(rng.integers(0, n_servers))
        c = int(rng.integers(1, 8))
        if st.free_cores[srv] >= c:
            st.place(srv, c, float(rng.uniform(0, 1)),
                     bool(rng.random() < 0.5))
    return st


def _batch(seed, b=48):
    rng = np.random.default_rng(seed)
    return (rng.choice([1, 2, 4, 8], b).astype(np.float64),
            rng.random(b) < 0.4, rng.uniform(0.05, 1.0, b),
            np.ones(b, bool))


def _mem(st):
    """A GB ledger per chassis (total and NUF slice) for the state."""
    rng = np.random.default_rng(5)
    gb = rng.uniform(0.0, 200.0, st.n_chassis)
    return gb, gb * rng.uniform(0.0, 1.0, st.n_chassis)


def _pair(rp, st, dtype, n, **kw):
    """The reference's and the port's sharded state over the same host
    state (call the reference inside the 64-bit context for float64)."""
    gb, nuf = _mem(st)
    rdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    rsh = reference_serve("sharding").shard_state(
        rp.device_state(st, rdt, mem_gb=gb, mem_nuf=nuf), n, **kw)
    psh = S.shard_state(P.device_state(st, dtype, "cpu", mem_gb=gb,
                                       mem_nuf=nuf), n, **kw)
    return rsh, psh


def _assert_state_equal(got, want, what=""):
    """Every leaf of a port `ShardedState` equal to the reference's."""
    for f in ("free_cores", "gamma_uf", "gamma_nuf", "res_peak", "rho_max",
              "chassis_of", "chassis_servers", "mem_nuf"):
        np.testing.assert_array_equal(getattr(got.shards, f).numpy(),
                                      np.asarray(getattr(want.shards, f)),
                                      err_msg=f"{what} {f}")
    for f in ("global_server", "global_chassis", "shard_of_server",
              "local_of_server", "res_cap", "pool"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what} {f}")


def _assert_info_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def _mesh(n):
    """The mesh leg on the CPU: one position a shard, one device."""
    return S.shard_mesh(n, devices=("cpu",) * n)


def _legs(shards, mesh_shards=(2, 4)):
    """(n, on_mesh) cases: the batch-axis leg at each of `shards` (ids as
    before the mesh leg), the mesh leg at each of `mesh_shards`."""
    return [pytest.param(n, False, id=str(n)) for n in shards] + [
        pytest.param(n, True, id=f"mesh{n}") for n in mesh_shards]


def _assert_same(got, want, what=""):
    """Two results of the port bit-equal, leaf by leaf (NamedTuples of
    tensors, arrays and numbers, nested)."""
    if isinstance(got, dict):
        _assert_info_equal(got, want)
    elif torch.is_tensor(got):
        assert torch.equal(got, want), what
    elif isinstance(got, tuple):
        assert type(got) is type(want) and len(got) == len(want), what
        for k, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{what}[{k}]")
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _place(on_mesh, psh, *args, **kw):
    """`place_group_sharded` on the batch axis, or on the CPU mesh too,
    whose result, stacked back (`from_mesh`), must be bit-equal to the
    batch-axis leg's on the same inputs; returns the leg's result in
    stacked form."""
    want = S.place_group_sharded(psh, *args, **kw)
    if not on_mesh:
        return want
    got = S.place_group_sharded(psh, *args, mesh=_mesh(psh.n_shards), **kw)
    assert isinstance(got[0], S.OnMesh)
    assert got[0].devices == (torch.device("cpu"),) * psh.n_shards
    got = tuple(S.from_mesh(x) for x in got)
    _assert_same(got, want, "mesh leg against the batch-axis leg")
    return got


# --- host helpers ---------------------------------------------------------

def test_host_helpers_match_reference(rs):
    for c, n in ((12, 1), (12, 3), (60, 4), (60, 5)):
        np.testing.assert_array_equal(S.chassis_to_shard(c, n),
                                      rs.chassis_to_shard(c, n))
    with pytest.raises(ValueError, match="divide"):
        S.chassis_to_shard(12, 5)
    for b, n in ((48, 4), (30, 3), (8, 1)):
        for rnd in range(n):
            t = S.route_shard(b, n, rnd)
            np.testing.assert_array_equal(t, rs.route_shard(b, n, rnd))
            assert np.bincount(t, minlength=n).max() == b // n
            pending = np.sort(np.random.default_rng(rnd).choice(
                b, b // 2, replace=False))
            for x, y in zip(S._pack_round(pending, t, n, b // n),
                            rs._pack_round(pending, t, n, b // n)):
                np.testing.assert_array_equal(x, y)
    from repro.core.resources import ResourceVector as RVector
    for w, cores, gb in ((6000.0, None, None), (6000.0, 900.0, 4000.0),
                         (None, 300.0, None), (100.0, None, None)):
        np.testing.assert_array_equal(
            S.resource_pool_from_budget(ResourceVector(w, cores, gb), 48),
            rs.resource_pool_from_budget(RVector(w, cores, gb), 48))
        assert S.rho_pool_from_budget(w, 48) == rs.rho_pool_from_budget(w, 48)


def test_split_caps_and_departures_match_reference(rs, rp):
    st = _loaded(2)
    rsh, psh = _pair(rp, st, torch.float32, 4)
    rng = np.random.default_rng(3)
    chassis = rng.permutation(12)[:7]
    power, t = rng.uniform(400, 900, 7), rng.uniform(0, 50, 7)
    for x, y in zip(S.split_caps(psh, chassis, power, t),
                    rs.split_caps(rsh, chassis, power, t)):
        np.testing.assert_array_equal(x, y)
    servers = rng.integers(-3, 48, 30)
    args = (servers, rng.choice([1, 2, 4], 30).astype(float),
            rng.uniform(0.1, 1, 30), rng.random(30) < 0.5,
            rng.uniform(0, 16, 30))
    for x, y in zip(S.split_departures(psh, *args),
                    rs.split_departures(rsh, *args)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n,on_mesh", _legs(SHARDS))
def test_shard_and_unshard_match_reference(rs, rp, n, on_mesh):
    st = _loaded(4)
    cap = np.random.default_rng(n).uniform(20, 80, (12, 3))
    for kw in (dict(), dict(rho_cap=cap[:, 0], pool_total=300.0),
               dict(rho_cap=cap, pool_total=np.array([300.0, np.inf,
                                                      2000.0]))):
        with jax.enable_x64(True):
            rsh, psh = _pair(rp, st, torch.float64, n, **kw)
            if on_mesh:
                mesh = S.device_put_sharded_state(psh, _mesh(n))
                assert [g.n_shards for g in mesh.groups] == [1] * n
                _assert_same(S.from_mesh(mesh), psh, "mesh round trip")
                psh = mesh
            _assert_state_equal(S.from_mesh(psh), rsh,
                                f"{n} shards {sorted(kw)}")
            back, want = S.unshard_state(psh), rs.unshard_state(rsh)
            for f in want._fields:
                np.testing.assert_array_equal(
                    getattr(back, f).numpy(), np.asarray(getattr(want, f)),
                    err_msg=f)
        gb, nuf = _mem(st)
        orig = P.device_state(st, torch.float64, "cpu", mem_gb=gb,
                              mem_nuf=nuf)
        for f in orig._fields:
            assert torch.equal(getattr(back, f), getattr(orig, f)), f


# --- the protocol in float64 ----------------------------------------------

@pytest.mark.parametrize("n,on_mesh", _legs(SHARDS))
@pytest.mark.parametrize("policy", POLICIES, ids=POLICY_IDS)
def test_place_group_sharded_float64_bit_equal(rs, rp, policy, n, on_mesh):
    """Unbudgeted and under a pool that runs dry mid-batch: servers, info,
    every state leaf and the pools equal the reference's bit for bit, on
    either leg."""
    st = _loaded(1)
    cores, uf, p95, valid = _batch(2)
    valid[5::11] = False                      # padding rows in the batch
    mem = cores * 4.0
    for pool in (None, 40.0, np.array([60.0, 150.0, np.inf])):
        with jax.enable_x64(True):
            rsh, psh = _pair(rp, st, torch.float64, n, pool_total=pool)
            rsh, want, rinfo = rs.place_group_sharded(
                rsh, cores, uf, p95, valid, RPolicy(**policy), 40,
                mem_gb=mem)
        psh, got, info = _place(
            on_mesh, psh, cores, uf, p95, valid, SchedulerPolicy(**policy),
            40, mem_gb=mem)
        np.testing.assert_array_equal(got, want)
        _assert_info_equal(info, rinfo)
        _assert_state_equal(psh, rsh, f"pool {pool}")
        if pool is not None and n > 1:
            assert info["spilled"] > 0


@pytest.mark.parametrize("n,on_mesh", _legs([3, 4], [4]))
def test_tiny_pool_fails_tokens_and_holds_the_budget(rs, rp, n, on_mesh):
    st = _loaded(1)
    cores, uf, p95, valid = _batch(2)
    pool_total = 15.0
    with jax.enable_x64(True):
        rsh, psh = _pair(rp, st, torch.float64, n, pool_total=pool_total)
        rsh, want, rinfo = rs.place_group_sharded(
            rsh, cores, uf, p95, valid, RPolicy(alpha=0.8), 40)
    psh, got, info = _place(on_mesh, psh, cores, uf, p95, valid,
                            SchedulerPolicy(alpha=0.8), 40)
    np.testing.assert_array_equal(got, want)
    _assert_info_equal(info, rinfo)
    _assert_state_equal(psh, rsh)
    used = (p95 * cores)[got >= 0].sum()
    assert used <= pool_total + 1e-9
    assert (got == P.FAIL_TOKENS).any()
    assert psh.pool[:, 0].sum().item() == pytest.approx(pool_total - used)
    assert info["tokens_drawn"] == pytest.approx(used)


def test_spillover_lands_on_other_shards(rs, rp):
    """Shard 0's servers are full: its home arrivals spill and land on the
    other shards, as in the reference, and a repeat is identical."""
    st = _loaded(0, n=0)
    for srv in range(12):                     # shard 0 owns servers 0-11
        st.place(srv, 40, 0.5, True)
    cores, uf, p95, valid = _batch(5, 32)
    policy = SchedulerPolicy(alpha=0.8)
    rsh, psh = _pair(rp, st, torch.float32, 4)
    _, want, rinfo = rs.place_group_sharded(rsh, cores, uf, p95, valid,
                                            RPolicy(alpha=0.8), 40)
    outs = [S.place_group_sharded(psh, cores, uf, p95, valid, policy, 40)
            for _ in range(2)]
    for _, got, info in outs:
        np.testing.assert_array_equal(got, want)
        _assert_info_equal(info, rinfo)
    assert rinfo["spilled"] > 0 and rinfo["spill_admitted"] > 0
    home0 = want[S.route_shard(32, 4) == 0]
    assert (home0[home0 >= 0] >= 12).all()


def test_spillover_reaches_the_one_feasible_server(rs, rp):
    st = _loaded(0, n_servers=16, per_chassis=4, n=0)
    for srv in range(16):
        st.place(srv, 30 if srv == 13 else 38, 0.5, True)
    args = (np.full(4, 8.0), np.ones(4, bool), np.full(4, 0.5),
            np.ones(4, bool))
    rsh, psh = _pair(rp, st, torch.float32, 4)
    _, want, _ = rs.place_group_sharded(rsh, *args, RPolicy(alpha=0.8), 40)
    _, got, _ = S.place_group_sharded(psh, *args, SchedulerPolicy(alpha=0.8),
                                      40)
    np.testing.assert_array_equal(got, want)
    assert (got == 13).sum() == 1 and (got < 0).sum() == 3


def test_batch_must_divide_by_shards(rp):
    _, psh = _pair(rp, _loaded(0), torch.float32, 4)
    with pytest.raises(ValueError, match="divisible"):
        S.place_group_sharded(psh, *_batch(0, 30), SchedulerPolicy(), 40)


@pytest.mark.parametrize("n,on_mesh", _legs([2, 3, 4]))
def test_place_group_sharded_float32(rs, rp, n, on_mesh):
    """float32, the serving dtype: decisions, info and states equal the
    reference's, on either leg. The pools are bit-equal too: the walk
    draws one subtraction an admission and the rebalance adds the rows in
    index order, which is the order XLA's reduction takes at these
    sizes."""
    st = _loaded(6, n_servers=48, per_chassis=4, n=200)
    cores, uf, p95, valid = _batch(8)
    rsh, psh = _pair(rp, st, torch.float32, n,
                     pool_total=np.array([70.0, 120.0, np.inf]))
    rsh, want, rinfo = rs.place_group_sharded(rsh, cores, uf, p95, valid,
                                              RPolicy(alpha=0.8), 40)
    psh, got, info = _place(on_mesh, psh, cores, uf, p95, valid,
                            SchedulerPolicy(alpha=0.8), 40)
    np.testing.assert_array_equal(got, want)
    assert info["spilled"] > 0 and (got == P.FAIL_TOKENS).any()
    _assert_info_equal(info, rinfo)
    _assert_state_equal(psh, rsh)


KNOBS = [(0, True), (1, True), (None, False), (1, False)]


@pytest.mark.parametrize("on_mesh", [False, True], ids=["batch", "mesh4"])
@pytest.mark.parametrize("spill_rounds,rebalance", KNOBS,
                         ids=["home_only", "one_spill", "no_rebalance",
                              "one_spill_no_rebalance"])
def test_spill_rounds_and_rebalance_match_reference(rs, rp, spill_rounds,
                                                    rebalance, on_mesh):
    """The protocol's two knobs at 4 shards under a pool that spills:
    `spill_rounds` 0 (the home round alone), 1 or None (N-1), and
    `rebalance=False` (each pool left as its shard drew it) give the
    reference's servers, info, states and pools bit for bit in float64,
    on either leg."""
    st = _loaded(1)
    cores, uf, p95, valid = _batch(2)
    kw = dict(mem_gb=cores * 4.0, spill_rounds=spill_rounds,
              rebalance=rebalance)
    with jax.enable_x64(True):
        rsh, psh = _pair(rp, st, torch.float64, 4,
                         pool_total=np.array([60.0, 150.0, np.inf]))
        rsh, want, rinfo = rs.place_group_sharded(
            rsh, cores, uf, p95, valid, RPolicy(alpha=0.8), 40, **kw)
    psh, got, info = _place(on_mesh, psh, cores, uf, p95, valid,
                            SchedulerPolicy(alpha=0.8), 40, **kw)
    np.testing.assert_array_equal(got, want)
    _assert_info_equal(info, rinfo)
    _assert_state_equal(psh, rsh)
    rounds = 1 + (3 if spill_rounds is None else spill_rounds)
    assert info["rounds"] == rounds
    assert (info["spilled"] > 0) == (spill_rounds != 0)


@pytest.mark.parametrize("policy", POLICIES, ids=POLICY_IDS)
def test_one_shard_is_place_batch(rp, policy):
    """One shard decides as the port's unsharded walk, and leaves its
    state; with a pool, as `place_batch_pooled`."""
    st = _loaded(3, n_servers=36, per_chassis=12, n=200)
    cores, uf, p95, valid = _batch(7)
    pol = SchedulerPolicy(**policy)
    dst = P.device_state(st, torch.float64, "cpu")
    want_st, want = P.place_batch(dst, cores, uf, p95, valid,
                                  np.full(3, np.inf), pol, 40)
    sh, got, info = S.place_group_sharded(S.shard_state(dst, 1), cores, uf,
                                          p95, valid, pol, 40)
    np.testing.assert_array_equal(got, want.numpy())
    assert info["spilled"] == 0 and info["rounds"] == 1
    back = S.unshard_state(sh)
    for f in want_st._fields:
        assert torch.equal(getattr(back, f), getattr(want_st, f)), f
    pst, pgot, left = P.place_batch_pooled(dst, 30.0, cores, uf, p95, valid,
                                           np.full(3, np.inf), pol, 40)
    sh, got, _ = S.place_group_sharded(
        S.shard_state(dst, 1, pool_total=30.0), cores, uf, p95, valid, pol,
        40)
    np.testing.assert_array_equal(got, pgot.numpy())
    assert torch.equal(sh.pool[0], left)
    assert (pgot == P.FAIL_TOKENS).any()


def test_place_batch_pooled_matches_reference(rp):
    st = _loaded(3, n_servers=36, per_chassis=12, n=200)
    cores, uf, p95, valid = _batch(7)
    for pool in (25.0, np.array([80.0, 60.0, np.inf])):
        with jax.enable_x64(True):
            rst, want, rleft = rp.place_batch_pooled(
                rp.device_state(st, jnp.float64), pool, cores, uf, p95,
                valid, np.full(3, np.inf), RPolicy(alpha=0.8), 40)
        pst, got, left = P.place_batch_pooled(
            P.device_state(st, torch.float64, "cpu"), pool, cores, uf, p95,
            valid, np.full(3, np.inf), SchedulerPolicy(alpha=0.8), 40)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(left.numpy(), np.asarray(rleft))
        np.testing.assert_array_equal(pst.res_peak.numpy(),
                                      np.asarray(rst.res_peak))


# --- the fused home round, departures, and the planes ---------------------

def _windows(n_chassis, rng, w=3):
    """W unique-chassis sample windows over the fleet."""
    out = []
    for k in range(w):
        ch = rng.permutation(n_chassis)[:rng.integers(3, n_chassis)]
        out.append((ch, rng.uniform(1300.0, 2300.0, len(ch)),
                    k * 10.0 + rng.uniform(0, 5, len(ch))))
    return out


def test_fused_home_round_matches_reference_and_standalone_windows(rs, rp):
    _fused_home_round(rs, rp, on_mesh=False)


def test_fused_home_round_on_a_mesh(rs, rp):
    """The case above on a CPU mesh of 2 positions, held to the batch
    axis bit for bit: the fused round (state, servers, emergency state and
    sweep) and the standalone windows of `apply_caps_sharded(mesh=)`."""
    _fused_home_round(rs, rp, on_mesh=True)


def _fused_home_round(rs, rp, on_mesh):
    re = reference_serve("emergency")
    st = _loaded(7, n_servers=48, per_chassis=12, n=300)
    cores, uf, p95, valid = _batch(3)
    cfg = E.EmergencyConfig.from_model(1560.0, dwell_s=60.0)
    rcfg = re.EmergencyConfig.from_model(1560.0, dwell_s=60.0)
    rsh, psh = _pair(rp, st, torch.float32, 2, pool_total=120.0)
    wins = _windows(4, np.random.default_rng(0))
    caps = [np.stack([S.split_caps(psh, *w)[k] for w in wins], axis=1)
            for k in range(3)]
    remer = rs.init_emergency_sharded(4, 2)
    rsh2, want, rinfo, remer, rsweep = rs.place_group_sharded(
        rsh, cores, uf, p95, valid, RPolicy(alpha=0.8), 40, emer=remer,
        caps=tuple(caps), ecfg=rcfg)
    pemer = S.init_emergency_sharded(4, 2, device="cpu")
    psh2, got, info, pemer2, sweep = _place(
        on_mesh, psh, cores, uf, p95, valid, SchedulerPolicy(alpha=0.8), 40,
        emer=pemer, caps=tuple(caps), ecfg=cfg)
    np.testing.assert_array_equal(got, want)
    _assert_info_equal(info, rinfo)
    _assert_state_equal(psh2, rsh2)
    for f, a, b in zip(remer._fields, pemer2, remer):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert int(sweep.alarms) == int(rsweep.alarms) > 0
    assert int(sweep.samples) == int(rsweep.samples)
    np.testing.assert_allclose(sweep.cut_w, rsweep.cut_w, rtol=1e-6)
    # W standalone windows ahead of a plain placement: the same states
    mesh = _mesh(2) if on_mesh else None
    solo = pemer
    for w in wins:
        solo, out = S.apply_caps_sharded(cfg, psh, solo, *w, mesh=mesh)
        assert isinstance(solo, S.OnMesh) == on_mesh
        assert out.alarm.shape == (2, 2)
    psh3, got3, _ = _place(on_mesh, psh, cores, uf, p95, valid,
                           SchedulerPolicy(alpha=0.8), 40)
    np.testing.assert_array_equal(got3, got)
    solo = S.from_mesh(solo)
    for f, a, b in zip(solo._fields, solo, pemer2):
        assert torch.equal(a, b), f


def test_remove_sharded_round_trips_state_and_pool(rs, rp):
    _remove_round_trip(rs, rp, on_mesh=False)


def test_remove_sharded_on_a_mesh(rs, rp):
    """The round trip above on a CPU mesh of 4 positions: placement and
    departures bit-equal to the batch axis's, the state staying on the
    mesh."""
    _remove_round_trip(rs, rp, on_mesh=True)


def _remove_round_trip(rs, rp, on_mesh):
    st = _loaded(6)
    pool_total = 200.0
    cores, uf, p95, valid = _batch(9, 16)
    mem = cores * 4.0
    with jax.enable_x64(True):
        rsh0, psh0 = _pair(rp, st, torch.float64, 4, pool_total=pool_total)
        rsh, want, _ = rs.place_group_sharded(rsh0, cores, uf, p95, valid,
                                              RPolicy(alpha=0.8), 40,
                                              mem_gb=mem)
        rsh = rs.remove_sharded(rsh, want, cores, p95, uf, mem_gb=mem)
    psh, got, _ = _place(on_mesh, psh0, cores, uf, p95, valid,
                         SchedulerPolicy(alpha=0.8), 40, mem_gb=mem)
    np.testing.assert_array_equal(got, want)
    if on_mesh:
        on = S.remove_sharded(S.device_put_sharded_state(psh, _mesh(4)),
                              got, cores, p95, uf, mem_gb=mem)
        assert isinstance(on, S.OnMesh)
        on = S.from_mesh(on)
    psh = S.remove_sharded(psh, got, cores, p95, uf, mem_gb=mem)
    if on_mesh:
        _assert_same(on, psh, "departures on the mesh")
    for f in psh.shards._fields:
        np.testing.assert_allclose(getattr(psh.shards, f).numpy(),
                                   getattr(psh0.shards, f).numpy(),
                                   atol=1e-9, err_msg=f)
        np.testing.assert_allclose(getattr(psh.shards, f).numpy(),
                                   np.asarray(getattr(rsh.shards, f)),
                                   atol=1e-12, err_msg=f)
    # every axis of the pool gets back what it gave, shard by shard
    np.testing.assert_allclose(psh.pool.numpy(), np.asarray(rsh.pool),
                               rtol=1e-12)
    np.testing.assert_allclose(psh.pool[:, 0].sum().item(), pool_total,
                               rtol=1e-12)
    # departures of an unknown server code are ignored
    again = S.remove_sharded(psh, np.array([-1, -3]), [4.0, 2.0],
                             [0.5, 0.5], [True, False])
    for a, b in zip(again.shards, psh.shards):
        assert torch.equal(a, b)
    assert torch.equal(again.pool, psh.pool)


def _close(got, want, rtol, what):
    """Every field of a port NamedTuple against the reference's: integer
    and boolean fields equal, float fields within `rtol`."""
    for f, a, b in zip(got._fields, got, want):
        a, b = a.numpy(), np.asarray(b)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-9,
                                       err_msg=f"{what} {f}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")


@pytest.mark.parametrize("dtype,on_mesh", [
    pytest.param(torch.float32, False, id="dtype0"),
    pytest.param(torch.float64, False, id="dtype1"),
    pytest.param(torch.float32, True, id="mesh3-float32"),
    pytest.param(torch.float64, True, id="mesh3-float64")])
def test_sharded_planes_match_reference(rs, rp, dtype, on_mesh):
    """Four windows through the sharded emergency, balloon-then-cap and
    adaptive steps at 3 shards. Against the reference, per shard: alarms,
    p-states, RAPL, balloon inflations, window counts and every ratio
    decision equal; the float fields within rounding (rtol 1e-12 in
    float64, 1e-6 in float32), since the reference sums each chassis'
    blades in XLA's order and the port in numpy's (Queue 3). Against the
    port's own unsharded steps the emergency and balloon states are
    bit-equal: the shard axis changes no chassis' arithmetic. On a CPU
    mesh of 3 positions every output and state is bit-equal to the batch
    axis's."""
    re, rb = reference_serve("emergency"), reference_serve("ballooning")
    ra = reference_serve("adaptive")
    st = _loaded(8, n_servers=48, per_chassis=4, n=400)
    budget = 4 * 112.0 + 60.0
    ecfg = E.EmergencyConfig.from_model(budget, dwell_s=60.0,
                                        blades_per_chassis=4)
    recfg = re.EmergencyConfig.from_model(budget, dwell_s=60.0,
                                          blades_per_chassis=4)
    akw = dict(window=4, min_history=2, blades_per_chassis=4)
    acfg, racfg = A.AdaptiveConfig(**akw), ra.AdaptiveConfig(**akw)
    bcfg, rbcfg = B.BallooningConfig(), rb.BallooningConfig()
    rdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    rtol = 1e-12 if dtype == torch.float64 else 1e-6
    with jax.enable_x64(dtype == torch.float64):
        rsh, psh = _pair(rp, st, dtype, 3)
        remer = rs.init_emergency_sharded(12, 3, rdt)
        rbst = rs.init_ballooning_sharded(12, 3, rdt)
        rast = rs.init_adaptive_sharded(racfg, 12, 3, rdt)
        remer2 = remer
        pemer = S.init_emergency_sharded(12, 3, dtype, "cpu")
        pbst = S.init_ballooning_sharded(12, 3, dtype, "cpu")
        past = S.init_adaptive_sharded(acfg, 12, 3, dtype, "cpu")
        pemer2 = pemer
        mesh = _mesh(3) if on_mesh else None
        memer = memer2 = pemer
        mbst, mast = pbst, past
        flat = S.unshard_state(psh)
        rho_lv = E.chassis_rho_levels(flat.gamma_nuf, flat.gamma_uf,
                                      flat.chassis_servers)
        uemer = E.init_emergency(12, dtype=dtype, device="cpu")
        ubst = B.init_ballooning(12, dtype=dtype, device="cpu")
        for w in _windows(12, np.random.default_rng(11), 4):
            remer, rout = rs.apply_caps_sharded(recfg, rsh, remer, *w)
            pemer, cout = S.apply_caps_sharded(ecfg, psh, pemer, *w)
            _close(cout, rout, rtol, "caps")
            remer2, rbst, rout, rbout = rs.apply_caps_ballooned_sharded(
                recfg, rbcfg, rsh, remer2, rbst, *w)
            pemer2, pbst, out, bout = S.apply_caps_ballooned_sharded(
                ecfg, bcfg, psh, pemer2, pbst, *w)
            _close(out, rout, rtol, "balloon caps")
            _close(bout, rbout, rtol, "balloon")
            rast, raout = rs.apply_adaptive_sharded(racfg, rsh, rast, *w[:2])
            past, aout = S.apply_adaptive_sharded(acfg, psh, past, *w[:2])
            _close(aout, raout, rtol, "adaptive")
            if on_mesh:
                memer, mout = S.apply_caps_sharded(ecfg, psh, memer, *w,
                                                   mesh=mesh)
                memer2, mbst, mout2, mbout = S.apply_caps_ballooned_sharded(
                    ecfg, bcfg, psh, memer2, mbst, *w, mesh=mesh)
                mast, maout = S.apply_adaptive_sharded(acfg, psh, mast,
                                                       *w[:2], mesh=mesh)
                assert isinstance(memer, S.OnMesh)
                _assert_same((mout, mout2, mbout, maout),
                             (cout, out, bout, aout), "mesh outputs")
            # the same window unsharded, on the port's own steps
            pw, mask, ts = E.scatter_samples(12, *w, dtype, "cpu")
            ubst, ubout = B.balloon_step(bcfg, ecfg, ubst, rho_lv, pw,
                                         flat.mem_nuf, mask)
            uemer, _ = E.masked_step(ecfg, uemer, rho_lv, ubout.power_adj_w,
                                     mask, ts)
        if on_mesh:
            _assert_same(tuple(S.from_mesh(x) for x in (
                memer, memer2, mbst, mast)), (pemer, pemer2, pbst, past),
                "mesh states")
        _close(pemer, remer, rtol, "emergency state")
        _close(pemer2, remer2, rtol, "ballooned emergency state")
        _close(pbst, rbst, rtol, "balloon state")
        _close(past, rast, rtol, "adaptive state")
    for a, b in zip(pemer2, uemer):
        assert torch.equal(a.reshape(b.shape), b)
    assert torch.equal(pbst.ballooned_gb.reshape(12), ubst.ballooned_gb)
    assert bool(out.alarm.any()) and pbst.ballooned_gb.sum() > 0
    assert past.ratio.shape == (3,)


def test_rho_levels_per_shard_equal_unsharded(rp):
    """The per-shard gather of `chassis_rho_levels` gives, shard by shard,
    the unsharded levels of the chassis each shard owns."""
    st = _loaded(8, n_servers=48, per_chassis=4, n=400)
    dst = P.device_state(st, torch.float32, "cpu")
    want = E.chassis_rho_levels(dst.gamma_nuf, dst.gamma_uf,
                                dst.chassis_servers)
    sh = S.shard_state(dst, 3).shards
    got = E.chassis_rho_levels(sh.gamma_nuf, sh.gamma_uf,
                               sh.chassis_servers)
    assert torch.equal(got.reshape(12, 2), want)
