"""`repro_torch.launch.sharding` against `repro.launch.sharding`, spec for
spec: every parameter and optimizer-state leaf of the ten architectures
at full width (AdamW, Adafactor where the config says so), and the batch
and cache leaves of the four shapes, under the three strategies on six
meshes. Plus the DTensor placements a spec maps to (pod-major order) and
the constraint hook outside a strategy.

The meshes are stand-ins (axis names and sizes): the rules read nothing
else, so no process group is needed. The reference's shardings are taken
as bare specs by standing in for its `NamedSharding` in this test."""
import functools

import jax
import pytest
import torch

from repro.configs import registry as j_registry
from repro.configs.base import SHAPES as J_SHAPES
from repro.launch import sharding as jshd
from repro.launch import steps as j_steps
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshSpec, data_axes, debug_spec, \
    production_spec
from repro_torch.tree import leaves_with_path

MESHES = {
    "16x16": production_spec(False),
    "2x16x16": production_spec(True),
    "2x2": debug_spec(2, 2),
    "2x2x2": debug_spec(2, 2, multi_pod=True),
    "1x1": debug_spec(1, 1),
    "data16": MeshSpec((16,), ("data",)),
}
STRATEGIES = ("fsdp2d", "tp", "tp_serve")


class _StubMesh:
    def __init__(self, spec: MeshSpec):
        self.axis_names = spec.axis_names
        self.shape = spec.shape


def _flat_ref(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(spec) for path, spec in flat}


def _flat(tree) -> dict:
    return {"/".join(map(str, path)): tuple(s.spec)
            for path, s in leaves_with_path(tree)}


@functools.cache
def _ref_trees(arch: str):
    cfg = j_registry.ARCHS[arch]
    caches = {name: j_steps.cache_spec(cfg, shape)
              for name, shape in J_SHAPES.items() if shape.kind == "decode"}
    batches = {name: j_steps.input_specs(cfg, shape)
               for name, shape in J_SHAPES.items()}
    return (j_steps.params_spec(cfg), j_steps.opt_state_spec(cfg), batches,
            caches)


@functools.cache
def _port_trees(arch: str):
    cfg = registry.ARCHS[arch]
    caches = {name: steps.cache_spec(cfg, shape)
              for name, shape in SHAPES.items() if shape.kind == "decode"}
    batches = {name: steps.input_specs(cfg, shape)
               for name, shape in SHAPES.items()}
    return (steps.params_spec(cfg), steps.opt_state_spec(cfg), batches,
            caches)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_specs_equal_reference(monkeypatch, strategy, mesh_name):
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)
    spec = MESHES[mesh_name]
    jmesh = _StubMesh(spec)
    jstrat = jshd.make_strategy(strategy, jmesh)
    strat = shd.make_strategy(strategy, spec)
    n = 0
    for arch in registry.ARCHS:
        jp, jo, jb, jc = _ref_trees(arch)
        tp, to, tb, tc = _port_trees(arch)
        pairs = [(jshd.param_shardings(jstrat, jmesh, jp),
                  shd.param_shardings(strat, spec, tp)),
                 (jshd.opt_shardings(jstrat, jmesh, jo),
                  shd.opt_shardings(strat, spec, to))]
        pairs += [(jshd.batch_shardings(jstrat, jmesh, jb[s]),
                   shd.batch_shardings(strat, spec, tb[s])) for s in jb]
        pairs += [(jshd.cache_shardings(jstrat, jmesh, jc[s]),
                   shd.cache_shardings(strat, spec, tc[s])) for s in jc]
        for want, got in pairs:
            want, got = _flat_ref(want), _flat(got)
            assert got == want, (arch, {k: (got.get(k), want.get(k))
                                        for k in set(got) | set(want)
                                        if got.get(k) != want.get(k)})
            n += len(want)
    assert n >= 600              # every leaf of the ten architectures


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_activation_specs_equal_reference(strategy):
    """The spec `constrain` picks for each tag, at shapes where the rules'
    first candidate divides and where it does not."""
    for spec in MESHES.values():
        jmesh = _StubMesh(spec)
        jstrat = jshd.make_strategy(strategy, jmesh)
        strat = shd.make_strategy(strategy, spec)
        assert set(jstrat.activation_rules) == set(strat.activation_rules)
        for tag, rule in jstrat.activation_rules.items():
            for shape in ((32, 64, 128), (8, 48, 16, 64), (6, 40),
                          (64, 4096, 8, 128), (1, 7, 3)):
                cands = rule if isinstance(rule, (list, tuple)) and \
                    not isinstance(rule, jax.sharding.PartitionSpec) \
                    else [rule]
                fitted = [jshd._fit_spec_to_rank(s, len(shape))
                          for s in cands]
                want = next((s for s in fitted
                             if jshd._divisible(shape, s, jmesh)), None)
                if want is None:
                    want = jshd._drop_nondivisible(shape, fitted[0], jmesh)
                got = shd.activation_spec(strat.activation_rules[tag],
                                          shape, spec)
                assert tuple(got) == tuple(want), (tag, shape)


def test_unknown_strategy_raises():
    with pytest.raises(KeyError):
        shd.make_strategy("nope", MESHES["2x2"])


def test_first_divisible_candidate_and_drop():
    """test_substrate's cases: a stacked weight keeps its leading layer
    dim unsharded; a non-divisible trailing dim loses only its axis; a
    MoE stack with fewer experts than 'data' shards within experts."""
    mesh = MESHES["2x2"]
    strat = shd.make_strategy("fsdp2d", mesh)
    assert strat.param_spec("layers/attn/wq/w", (4, 64, 128), mesh) == \
        shd.P(None, "data", "model")
    assert strat.param_spec("lm_head/w", (64, 51865), mesh) == \
        shd.P("data", None)
    prod = MESHES["16x16"]
    strat = shd.make_strategy("fsdp2d", prod)
    assert strat.param_spec("layers/moe/gate", (56, 8, 6144, 16384),
                            prod) == shd.P(None, None, "data", "model")


def test_partition_spec_normalizes_one_axis_tuples():
    assert shd.P(("data",), None) == shd.P("data", None)
    assert shd.P(("pod", "data")) == (("pod", "data"),)
    assert data_axes(MESHES["2x2x2"]) == ("pod", "data")
    assert data_axes(MESHES["2x2"]) == ("data",)


def test_placements_pod_major_and_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES["2x16x16"]
    assert shd.placements(shd.P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.P("model", "data"), MESHES["16x16"]) == \
        (Shard(1), Shard(0))
    assert shd.placements(shd.P(None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(AssertionError, match="mesh order"):
        shd.placements(shd.P(("data", "pod")), mesh)


def test_pod_major_split_matches_xla_order():
    """A dim over ('pod', 'data') on a (2, 2, m) mesh: rank (p, d, ·)
    holds block p * 2 + d of it, the order XLA gives a tuple axis. The
    placements are applied left to right over the mesh dims, as DTensor
    applies them, for each mesh coordinate (no process group needed)."""
    from torch.distributed.tensor import Shard
    x = torch.arange(16)
    pl = shd.placements(shd.P(("pod", "data")), debug_spec(2, 2,
                                                           multi_pod=True))
    for p in range(2):
        for d in range(2):
            local = x
            for placement, coord, size in zip(pl, (p, d, 0), (2, 2, 2)):
                if isinstance(placement, Shard):
                    local = local.chunk(size, placement.dim)[coord]
            block = (p * 2 + d) * 4
            assert local.tolist() == list(range(block, block + 4))


def test_constrain_is_identity_outside_a_strategy():
    x = torch.ones(4, 4)
    assert shd.constrain(x, "residual") is x
    with shd.use_strategy(shd.make_strategy("fsdp2d", MESHES["2x2"]),
                          MESHES["2x2"]):
        # a plain tensor inside a strategy: still the identity
        assert shd.constrain(x, "residual") is x
    assert shd.current_strategy() is None
    assert shd.replicate(x) is x and shd.local(x) is x
