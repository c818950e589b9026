"""The port's dry-run (`repro_torch.launch.dryrun`) on fake process
groups, in subprocesses (a process group is never made inside a pytest
worker): the three reduced cells of tests/test_dryrun_small.py on the
(2, 2) and (2, 2, 2) debug meshes, and the full-width production cell
llama3-8b train_4k on (16, 16) under fsdp2d through the CLI.

Each run's `memory.argument_bytes` equals the per-device bytes that the
reference's shardings give (each leaf's shard shape times its itemsize,
the reference's specs computed here on a stand-in mesh); its FLOPs are
per device, so the (2, 2, 2) mesh, which splits the batch twice as far,
runs half the (2, 2) mesh's; and its collectives are counted."""
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import ShapeConfig as JShape
from repro.launch import sharding as jshd
from repro.launch.steps import step_for_shape as j_step_for_shape

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SMALL_ARCHS = ("llama3-8b", "mamba2-2.7b", "mixtral-8x22b")

SMALL = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import debug_spec
mp = sys.argv[1] == "1"
D.ensure_fake_group(8 if mp else 4)
mesh = D.dryrun_mesh(debug_spec(2, 2, multi_pod=mp))
out = {}
for arch in %r:
    rec = D.run_step(get_config(arch).reduced(),
                     ShapeConfig("t", 64, 8, "train"), mesh, impl="naive")
    out[arch] = rec
print("RESULT " + json.dumps(out))
""" % (SMALL_ARCHS,)


class _StubMesh:
    def __init__(self, sizes, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, sizes))


def _ref_argument_bytes(jcfg, jshape, sizes, axes) -> int:
    """Per-device bytes of the reference's step arguments under fsdp2d:
    each leaf's shard shape (dims over their spec's axes) times its
    itemsize."""
    mesh = _StubMesh(sizes, axes)
    strat = jshd.make_strategy("fsdp2d", mesh)
    _, args, names = j_step_for_shape(jcfg, jshape, impl="naive", n_data=2)
    rule = {"params": jshd.param_shardings, "opt_state": jshd.opt_shardings,
            "cache": jshd.cache_shardings}
    total = 0
    for name, arg in zip(names, args):
        # the reference's shardings as bare specs (the stand-in mesh has
        # no devices to make a NamedSharding of)
        with mock.patch.object(jshd, "NamedSharding",
                               lambda mesh, spec: spec):
            specs = rule.get(name, jshd.batch_shardings)(strat, mesh, arg)
        for leaf, spec in zip(jax.tree.leaves(arg), jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))):
            n = 1
            for dim, entry in zip(leaf.shape,
                                  tuple(spec) + (None,) * leaf.ndim):
                ax = () if entry is None else \
                    (entry if isinstance(entry, tuple) else (entry,))
                n *= dim // int(np.prod([mesh.shape[a] for a in ax] or [1]))
            total += n * leaf.dtype.itemsize
    return total


def _start(cmd, log_dir, name):
    """cmd in the background, its output in files (a pipe that fills
    while another process is waited on would stall it)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = open(os.path.join(log_dir, name + ".out"), "w+")
    err = open(os.path.join(log_dir, name + ".err"), "w+")
    return subprocess.Popen(cmd, env=env, stdout=out, stderr=err,
                            text=True), out, err


def _finish(started) -> str:
    proc, out, err = started
    proc.wait(timeout=900)
    out.seek(0)
    err.seek(0)
    text, errors = out.read(), err.read()
    out.close()
    err.close()
    assert proc.returncode == 0, errors[-3000:]
    return text


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two debug-mesh runs and the production cell, at once."""
    art = str(tmp_path_factory.mktemp("dryrun_torch"))
    small = {mp: _start([sys.executable, "-c", SMALL, mp], art, "small" + mp)
             for mp in ("0", "1")}
    cli = _start([sys.executable, "-m", "repro_torch.launch.dryrun",
                  "--arch", "llama3-8b", "--shape", "train_4k",
                  "--single-pod", "--strategy", "fsdp2d", "--artifact-dir",
                  art], art, "cli")
    results = {}
    for mp, started in small.items():
        line = [ln for ln in _finish(started).splitlines()
                if ln.startswith("RESULT ")][0]
        results[mp] = json.loads(line[len("RESULT "):])
    out = _finish(cli)
    with open(os.path.join(art, "llama3-8b__train_4k__pod1__fsdp2d.json")) \
            as f:
        prod = json.load(f)
    return results, prod, out


@pytest.mark.parametrize("multi_pod", ["0", "1"])
@pytest.mark.parametrize("arch", SMALL_ARCHS)
def test_debug_mesh_argument_bytes_equal_reference_specs(runs, arch,
                                                         multi_pod):
    small, _, _ = runs
    rec = small[multi_pod][arch]
    sizes, axes = ((2, 2, 2), ("pod", "data", "model")) if multi_pod == "1" \
        else ((2, 2), ("data", "model"))
    want = _ref_argument_bytes(j_config(arch).reduced(),
                               JShape("t", 64, 8, "train"), sizes, axes)
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["collectives"]["count"]["all-gather"] > 0


@pytest.mark.parametrize("arch", SMALL_ARCHS)
def test_flops_are_per_device(runs, arch):
    """fsdp2d splits the batch over pod x data: the (2, 2, 2) mesh holds
    half the (2, 2) mesh's tokens a device, so half its products. The
    MoE expert buffers split over 'data' alone (the reference's
    moe_buffer rule), so mixtral's expert products do not halve."""
    small, _, _ = runs
    one, two = (small[mp][arch]["cost"]["flops"] for mp in ("0", "1"))
    if arch.startswith("mixtral"):
        assert 0.5 < two / one < 1
    else:
        assert 0.4 < two / one < 0.6


def test_production_cell_through_the_cli(runs):
    _, rec, out = runs
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == [16, 16] and rec["impl"] == "naive"
    want = _ref_argument_bytes(j_config("llama3-8b"), J_SHAPES["train_4k"],
                               (16, 16), ("data", "model"))
    assert rec["memory"]["argument_bytes"] == want
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert "llama3-8b__train_4k__pod1__fsdp2d: ok" in out
