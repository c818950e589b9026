"""The dry-run's stand-ins and cost model against the reference, for all
40 (architecture x shape) cells of the registry: `input_specs`,
`params_spec`, `cache_spec` (whisper's primed cross K/V included) and
`opt_state_spec` on the `meta` device have the shapes and dtypes of
`jax.eval_shape`'s, leaf for leaf, and `launch.roofline.analytic_cost`
equals `repro.launch.roofline.analytic_cost` exactly."""
import functools

import jax
import numpy as np
import pytest

from repro.configs import registry as j_registry
from repro.configs.base import SHAPES as J_SHAPES
from repro.launch import roofline as j_roofline
from repro.launch import steps as j_steps
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import roofline, steps
from repro_torch.tree import leaves_with_path

CELLS = [(a.name, s.name) for a, s, _, _ in registry.all_cells()]


def _ref(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in flat}


def _port(tree) -> dict:
    out = {}
    for path, leaf in leaves_with_path(tree):
        if leaf is None:
            continue
        assert leaf.is_meta, path
        out["/".join(map(str, path))] = (
            tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
    return out


@functools.cache
def _arch_specs(arch):
    jcfg, cfg = j_registry.ARCHS[arch], registry.ARCHS[arch]
    return ((_ref(j_steps.params_spec(jcfg)),
             _ref(j_steps.opt_state_spec(jcfg))),
            (_port(steps.params_spec(cfg)), _port(steps.opt_state_spec(cfg))))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_meta_specs_equal_eval_shape(arch, shape):
    jcfg, cfg = j_registry.ARCHS[arch], registry.ARCHS[arch]
    jshape, tshape = J_SHAPES[shape], SHAPES[shape]
    (jp, jo), (tp, to) = _arch_specs(arch)
    assert tp == jp and to == jo
    assert _port(steps.input_specs(cfg, tshape)) == \
        _ref(j_steps.input_specs(jcfg, jshape))
    if tshape.kind == "decode":
        want = _ref(j_steps.cache_spec(jcfg, jshape))
        assert _port(steps.cache_spec(cfg, tshape)) == want
        if cfg.family == "audio":
            assert "cross/k" in want


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_cost_equals_reference(arch, shape):
    want = j_roofline.analytic_cost(j_registry.ARCHS[arch], J_SHAPES[shape])
    got = roofline.analytic_cost(registry.ARCHS[arch], SHAPES[shape])
    assert got.flops_global == want.flops_global
    assert got.hbm_bytes_global == want.hbm_bytes_global
    for chips in (256, 512):
        assert got.per_device(chips) == want.per_device(chips)


def test_step_for_shape_allocates_nothing():
    """arctic-480b's train cell: ~0.96 TB of weights, all on `meta`."""
    cfg = registry.ARCHS["arctic-480b"]
    step, args, names = steps.step_for_shape(cfg, SHAPES["train_4k"])
    assert names == ("params", "opt_state", "batch")
    flat = [t for a in args for _, t in leaves_with_path(a)]
    assert all(t.is_meta for t in flat)
    nbytes = sum(t.numel() * t.element_size() for _, t in
                 leaves_with_path(args[0]))
    assert nbytes > 9e11
    assert callable(step)


def test_roofline_row_uses_h100_peaks():
    cfg, shape = registry.ARCHS["llama3-8b"], SHAPES["train_4k"]
    rec = {"collectives": {"total_bytes": 5e10}}
    row = roofline.roofline_row(rec, cfg, shape, chips=256)
    est = roofline.analytic_cost(cfg, shape)
    np.testing.assert_allclose(row["t_compute_s"],
                               est.flops_global / 256 / 989e12)
    np.testing.assert_allclose(row["t_memory_s"],
                               est.hbm_bytes_global / 256 / 3.35e12)
    np.testing.assert_allclose(row["t_collective_s"], 1.0)
    assert row["dominant"] in ("compute", "memory", "collective")


def test_roofline_report_reads_dryrun_artifacts(tmp_path, capsys):
    """`python -m repro_torch.launch.roofline` over a directory of
    dry-run records: one row an `ok` record of the chosen mesh, the
    skipped and failed ones named."""
    import json
    recs = [
        {"arch": "llama3-8b", "shape": "train_4k", "multi_pod": False,
         "strategy": "fsdp2d", "status": "ok",
         "memory": {"argument_bytes": 3 * 2**30},
         "cost": {"flops": 1.5e15},
         "collectives": {"total_bytes": 1e11}},
        {"arch": "llama3-8b", "shape": "long_500k", "multi_pod": False,
         "strategy": "fsdp2d", "status": "skipped", "reason": "full attn"},
        {"arch": "llama3-8b", "shape": "train_4k", "multi_pod": True,
         "strategy": "fsdp2d", "status": "ok",
         "memory": {"argument_bytes": 1}, "cost": {"flops": 1},
         "collectives": {"total_bytes": 1}},
    ]
    for i, rec in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(rec))
    out = tmp_path / "rows.json"
    roofline.main(["--artifacts", str(tmp_path), "--out", str(out)])
    rows = json.loads(out.read_text())
    assert len(rows) == 1 and rows[0]["dryrun_flops_dev"] == 1.5e15
    np.testing.assert_allclose(rows[0]["t_collective_s"], 2.0)
    printed = capsys.readouterr().out
    assert "llama3-8b/long_500k/fsdp2d: SKIPPED" in printed


def test_dryrun_list_names_every_cell(capsys):
    from repro_torch.launch import dryrun
    dryrun.main(["--list"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(CELLS)
    assert sum("SKIP" in ln for ln in lines) == sum(
        not ok for _, _, ok, _ in registry.all_cells())
