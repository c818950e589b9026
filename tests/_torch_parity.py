"""Shared helpers of the port's parity tests (`tests/test_torch_*.py`):
hand the JAX package's objects to `repro_torch.convert` as numpy dicts,
import `repro.serve` past its collection-time DeprecationWarning, and the
`cuda` fixture of the tests that need the card."""
import importlib
import warnings

import numpy as np
import pytest
import torch

from repro_torch.convert import FORESTS


@pytest.fixture
def cuda():
    """The card, for tests marked `cuda`; they skip without one. The
    kernels build and run only there, so the check is made per test, not
    when a module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only "
                    "on the card")
    return torch.device("cuda")


def reference_serve(submodule: str | None = None):
    """`repro.serve`, or its `submodule`, imported with the reference's
    jax.experimental.shard_map DeprecationWarning silenced (the repo's
    pytest settings turn it into an error at import time). Submodules are
    looked up by name: after a failed import of `repro.serve` earlier in
    the process (another test file's collection), they stay loaded but
    are no longer attributes of the package."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pkg = importlib.import_module("repro.serve")
        if submodule is None:
            return pkg
        return importlib.import_module(f"repro.serve.{submodule}")


def service_dict(svc) -> dict:
    """A trained `PredictionService` as `convert.service_from_numpy`
    takes it."""
    forests = (svc.criticality, svc.p95.stage1, svc.p95.low, svc.p95.high)
    d = {name: {"feat_idx": f.feat_idx, "thresholds": f.thresholds,
                "leaf_values": f.leaf_values, "kind": f.kind}
         for name, f in zip(FORESTS, forests)}
    d["confidence_gate"] = svc.confidence_gate
    return d


def table_dict(table) -> dict:
    """A `SubscriptionTable` as `convert.table_from_numpy` takes it."""
    return {f: np.asarray(a) for f, a in zip(table._fields, table)}
