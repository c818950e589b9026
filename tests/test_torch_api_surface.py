"""Pin the port's public front doors against the reference's, read at run
time: `repro_torch.serve` and `repro_torch.sim` export what `repro.serve`
and `repro.sim` export, but for the differences named here; the kernel
packages re-export their calls without building or loading CUDA; the
constants and oracles the reference's callers import exist with the same
values. A new or dropped name on either side fails here until it is
listed, as `tests/test_api_surface.py` pins the reference's.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from _torch_parity import reference_serve  # noqa: E402

import repro_torch.serve  # noqa: E402
import repro_torch.sim  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

#: The reference's names the port does not export: the `shard_map` axis
#: (the port's mesh leg groups one shard a device in `OnMesh`, with no
#: named axis) and the jnp bucket map, whose twin is `bucket_to_p95_torch`.
SERVE_REFERENCE_ONLY = {"SHARD_AXIS", "bucket_to_p95_jnp"}
#: The port's names the reference does not export: the numpy oracles its
#: torch twins are held to, its torch buckets, the row-sharded table of
#: its mesh leg, the packed forest stack and its metadata, and the stale
#: gate that the reference keeps in `serve.adaptive` alone.
SERVE_NP_ORACLES = {
    "adaptive_step_np", "balloon_demand_w_np", "balloon_step_np",
    "chassis_rho_levels_np", "emergency_step_np", "init_adaptive_np",
    "init_ballooning_np", "init_emergency_np", "masked_step_np",
    "mitigation_due_np", "reset_dwell_np", "sampled_power_np",
    "scatter_samples_np", "util_from_power_np"}
SERVE_PORT_ONLY = SERVE_NP_ORACLES | {
    "p95_bucket_torch", "bucket_to_p95_torch", "ShardedTable",
    "ForestMeta", "PackedForest", "gate_ratio_on_stale"}


def test_serve_surface_matches_reference():
    ref = set(reference_serve().__all__)
    port = set(repro_torch.serve.__all__)
    assert len(port) == len(repro_torch.serve.__all__), "duplicates"
    assert ref - port == SERVE_REFERENCE_ONLY
    assert port - ref == SERVE_PORT_ONLY
    for name in port:
        assert hasattr(repro_torch.serve, name), name


def test_sim_surface_matches_reference():
    import repro.sim
    assert set(repro_torch.sim.__all__) == set(repro.sim.__all__)
    assert len(repro_torch.sim.__all__) == len(set(repro_torch.sim.__all__))
    for name in repro_torch.sim.__all__:
        assert hasattr(repro_torch.sim, name), name


def test_adaptive_module_all_matches_reference():
    from repro_torch.serve import adaptive
    ref = reference_serve("adaptive").__all__
    assert set(adaptive.__all__) - set(ref) == {"init_adaptive_np",
                                                "adaptive_step_np"}
    assert set(ref) <= set(adaptive.__all__)
    for name in adaptive.__all__:
        assert hasattr(adaptive, name), name


def test_constants_match_reference():
    from repro.core import timeseries as rts
    from repro_torch.core import timeseries as pts
    from repro_torch.serve import featurizer
    assert featurizer.N_FEATURES == reference_serve("featurizer").N_FEATURES
    assert pts.DEFAULT_DAYS == rts.DEFAULT_DAYS
    assert pts.SLOTS_PER_DAY == rts.SLOTS_PER_DAY


@pytest.mark.parametrize("package,name", [
    ("forest", "forest_predict"), ("flash_attention", "flash_attention"),
    ("ssd", "ssd"), ("template", "criticality_scores")])
def test_kernel_packages_reexport_without_building(package, name):
    """`from repro_torch.kernels.<k> import <call>`, as the reference's
    kernel packages allow, in a fresh process: no JAX, no reference, and
    no library built or loaded."""
    code = (f"import sys; from repro_torch.kernels.{package} import {name}; "
            "from repro_torch.kernels import build; "
            f"assert callable({name}); "
            "assert build.load.cache_info().currsize == 0; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(SRC)})


@pytest.mark.parametrize("kind", ["rf", "gb"])
def test_forest_predict_ref_matches_reference(kind):
    """The port's `forest_predict_ref` (signature and result) against the
    reference's, on a forest the reference trained, as arrays and as
    tensors."""
    from repro.core.forest import (train_gradient_boosting,
                                   train_random_forest)
    from repro.kernels.forest.ref import forest_predict_ref as j_ref

    from repro_torch.kernels.forest.ref import forest_predict_ref
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (300, 7)).astype(np.float32)
    y = rng.integers(0, 3, 300)
    y[x[:, 0] > 0] = 0
    trainer = train_random_forest if kind == "rf" \
        else train_gradient_boosting
    f = trainer(x, y, 3, n_trees=12, depth=4)
    want = np.asarray(j_ref(jnp.asarray(x), jnp.asarray(f.feat_idx),
                            jnp.asarray(f.thresholds),
                            jnp.asarray(f.leaf_values), kind))
    got = forest_predict_ref(x, f.feat_idx, f.thresholds, f.leaf_values,
                             kind)
    assert got.shape == (300, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    got_t = forest_predict_ref(*(torch.as_tensor(a) for a in (
        x, f.feat_idx, f.thresholds, f.leaf_values)), kind)
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())
    np.testing.assert_allclose(got.numpy(), f.predict_proba_np(x),
                               atol=1e-5)
