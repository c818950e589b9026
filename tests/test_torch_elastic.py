"""`repro_torch.runtime.elastic` against the six cases of
tests/test_elastic.py, and `resume_or_init(..., shardings=)`, on a
one-rank gloo DeviceMesh: meshes of shape
(1, 1) keep every strategy spec intact, while a mesh without the 'model'
axis exercises the drop-to-replicated fallback. The specs are held
against the reference's own, computed here with `repro.launch.sharding`
on a stand-in mesh of the same axes.

The process group lives in a subprocess (one run for the six cases); no
process group is made inside a pytest worker."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

SCRIPT = r"""
import json, os, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint import Checkpointer
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import MeshSpec, build_mesh, make_debug_mesh
from repro_torch.runtime.elastic import elastic_restore, reshard_plan
from repro_torch.tree import leaves, leaves_with_path

tmp = tempfile.mkdtemp()
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(tmp, "store"), 1), rank=0, world_size=1)
dm = make_debug_mesh(1, 1, device="cpu")
d_only = build_mesh(MeshSpec((1,), ("data",)), "cpu")

def meta(*shape):
    return torch.empty(shape, device="meta")

PARAMS_SHAPE = {
    "layers": {"attn": {"wq": {"w": meta(64, 128)}},
               "mlp": {"up": {"w": meta(64, 256), "b": meta(256)}}},
    "embed": {"w": meta(512, 64)},
}

def specs(tree):
    return {"/".join(map(str, p)): [list(e) if isinstance(e, tuple) else e
                                    for e in s.spec]
            for p, s in leaves_with_path(tree)}

def replicated(tree):
    return all(s.is_fully_replicated for s in leaves(tree))

out = {}
old, new = reshard_plan("fsdp2d", dm, dm, PARAMS_SHAPE)
out["same"] = {"old": specs(old), "new": specs(new),
               "placeable": all(isinstance(s, shd.NamedSharding)
                                and len(s.placements) == 2
                                for s in leaves(old)),
               "b_replicated": old["layers"]["mlp"]["up"]["b"]
               .is_fully_replicated}
old, _ = reshard_plan("fsdp2d", dm, dm, PARAMS_SHAPE)
new, _ = reshard_plan("tp_serve", dm, dm, PARAMS_SHAPE)
out["handoff"] = {"old": specs(old), "new": specs(new)}
old, new = reshard_plan("fsdp2d", dm, d_only, PARAMS_SHAPE)
out["axis_loss"] = {"old": specs(old), "new": specs(new),
                    "replicated": replicated(new)}
try:
    reshard_plan("nope", dm, dm, PARAMS_SHAPE)
    out["unknown"] = "no error"
except KeyError:
    out["unknown"] = "KeyError"

def params():
    rng = np.random.default_rng(0)
    return {"enc": {"wq": {"w": torch.from_numpy(
                rng.normal(size=(8, 4)).astype(np.float32))},
                    "b": torch.arange(4, dtype=torch.float32)},
            "half": torch.from_numpy(rng.normal(size=(4, 4)).astype(
                np.float32)).bfloat16()}

def restored_record(restored, want):
    rec = {"placements": {}, "exact": True, "dtypes": True,
           "dtensors": True}
    for (path, got), ref in zip(leaves_with_path(restored), leaves(want)):
        rec["placements"]["/".join(map(str, path))] = [
            repr(p) for p in got.placements]
        rec["dtensors"] &= isinstance(got, DTensor)
        full = got.full_tensor()
        rec["dtypes"] &= full.dtype == ref.dtype
        rec["exact"] &= bool(torch.equal(full.view(-1).float(),
                                         ref.view(-1).float()))
    return rec

ck = Checkpointer(os.path.join(tmp, "a"))
p = params()
ck.save(3, p)
restored, step = elastic_restore(ck, p, "fsdp2d", dm)
out["round_trip"] = dict(restored_record(restored, p), step=step,
                         want=[repr(x) for x in shd.placements(
                             shd.P("data", "model"), dm)])
ck = Checkpointer(os.path.join(tmp, "b"))
stale, fresh = params(), params()
fresh["enc"]["b"] = fresh["enc"]["b"] + 100.0
ck.save(1, stale)
ck.save(2, fresh)
restored, step = elastic_restore(ck, fresh, "tp_serve", dm)
out["newest"] = dict(restored_record(restored, fresh), step=step,
                     want=[repr(x) for x in shd.placements(
                         shd.P(None, "model"), dm)])
from repro_torch.runtime.fault_tolerance import (FaultToleranceConfig,
                                                 FaultTolerantLoop)
loop = FaultTolerantLoop(FaultToleranceConfig(), ck)
sh = shd.param_shardings(shd.make_strategy("fsdp2d", dm), dm, fresh)
state, step = loop.resume_or_init(lambda: stale, tree_like=fresh,
                                  shardings=sh)
out["resume"] = dict(restored_record(state, fresh), step=step)
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


class _StubMesh:
    def __init__(self, axes):
        self.axis_names = axes
        self.shape = dict.fromkeys(axes, 1)


PARAMS_SHAPE_REF = {
    "layers": {"attn": {"wq": {"w": (64, 128)}},
               "mlp": {"up": {"w": (64, 256), "b": (256,)}}},
    "embed": {"w": (512, 64)},
}


def _ref_specs(strategy, axes) -> dict:
    """The reference's specs for PARAMS_SHAPE on a mesh of `axes`."""
    import jax
    from repro.launch import sharding as jshd
    mesh = _StubMesh(axes)
    strat = jshd.make_strategy(strategy, mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        PARAMS_SHAPE_REF, is_leaf=lambda x: isinstance(x, tuple))
    return {"/".join(str(p.key) for p in path):
            [list(e) if isinstance(e, tuple) else e
             for e in strat.param_spec(
                 "/".join(str(p.key) for p in path), shape, mesh)]
            for path, shape in flat}


@pytest.fixture(scope="module")
def result():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][0]
    return json.loads(line[len("RESULT "):])


def test_reshard_plan_same_strategy_same_axes_is_stable(result):
    r = result["same"]
    want = _ref_specs("fsdp2d", ("data", "model"))
    assert r["old"] == r["new"] == want
    assert want["layers/attn/wq/w"] == ["data", "model"]
    assert want["embed/w"] == ["model", "data"]
    assert r["placeable"] and r["b_replicated"]


def test_reshard_plan_across_strategies_and_serve_handoff(result):
    r = result["handoff"]
    assert r["old"] == _ref_specs("fsdp2d", ("data", "model"))
    assert r["new"] == _ref_specs("tp_serve", ("data", "model"))
    assert r["new"]["layers/attn/wq/w"] == [None, "model"]
    assert r["new"]["embed/w"] == ["model", None]


def test_reshard_plan_axis_loss_falls_back_to_replication(result):
    r = result["axis_loss"]
    assert r["old"]["layers/attn/wq/w"] == ["data", "model"]
    assert r["new"] == _ref_specs("fsdp2d", ("data",))
    assert r["replicated"]


def test_reshard_plan_unknown_strategy_raises(result):
    assert result["unknown"] == "KeyError"


def test_elastic_restore_round_trips_onto_new_mesh(result):
    """Save whole, restore elastically: exact values (bfloat16 included)
    land as DTensors with the new mesh's placements."""
    r = result["round_trip"]
    assert r["step"] == 3
    assert r["dtensors"] and r["dtypes"] and r["exact"]
    assert r["placements"]["enc/wq/w"] == r["want"]
    assert r["placements"]["enc/b"] == ["Replicate()", "Replicate()"]


def test_elastic_restore_takes_newest_step_and_new_strategy(result):
    r = result["newest"]
    assert r["step"] == 2
    assert r["exact"]
    assert r["placements"]["enc/wq/w"] == r["want"]
    np.testing.assert_equal(r["want"], ["Replicate()", "Shard(dim=1)"])


def test_resume_or_init_places_the_restored_state(result):
    """`FaultTolerantLoop.resume_or_init(..., shardings=)` restores the
    newest commit onto the mesh, as `elastic_restore` does."""
    r = result["resume"]
    assert r["step"] == 2
    assert r["dtensors"] and r["dtypes"] and r["exact"]
    assert r["placements"]["enc/wq/w"] == ["Shard(dim=0)", "Shard(dim=1)"]
