"""Carry parameters and state across from plain numpy arrays.

The port never imports `repro`; a caller holding objects of the JAX
package (a trained `PredictionService`, a `SubscriptionTable`, a
`ClusterState`, LM parameters, an optimizer state) hands their arrays
over as dicts of numpy arrays, so both packages compute from the same
forests, aggregates, weights and moments.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.features import FEATURE_NAMES
from repro_torch.core.forest import ObliviousForest
from repro_torch.core.placement import ClusterState
from repro_torch.core.predictor import PredictionService, TwoStageP95Model
from repro_torch.device import resolve_device
from repro_torch.models.transformer import check_family
from repro_torch.serve.featurizer import SubscriptionTable

FORESTS = ("criticality", "stage1", "low", "high")


def service_from_numpy(d: dict) -> PredictionService:
    """`d`: for each of 'criticality', 'stage1', 'low' and 'high' a dict
    with `feat_idx` (T, D), `thresholds` (T, D), `leaf_values`
    (T, 2^D, K) and `kind` ('rf' or 'gb'); plus `confidence_gate`. The
    forests read the `core.features.FEATURE_NAMES` columns."""
    def forest(f: dict) -> ObliviousForest:
        return ObliviousForest(
            np.asarray(f["feat_idx"], np.int32),
            np.asarray(f["thresholds"], np.float32),
            np.asarray(f["leaf_values"], np.float32),
            kind=str(f["kind"]), n_features=len(FEATURE_NAMES))
    crit, s1, low, high = (forest(d[k]) for k in FORESTS)
    return PredictionService(crit, TwoStageP95Model(s1, low, high),
                             confidence_gate=float(d["confidence_gate"]))


def table_from_numpy(d: dict, device=None) -> SubscriptionTable:
    """`d`: the six `SubscriptionTable` columns by field name."""
    dev = resolve_device(device)
    return SubscriptionTable(*(
        torch.as_tensor(np.array(d[f], np.float32), device=dev)
        for f in SubscriptionTable._fields))


#: Leaves the reference keeps in float32 whatever the model dtype, by
#: leaf name, and subtrees it keeps in float32 whole, by key on the path
#: (the MoE router's weight is named `w`, like every dense weight).
F32_LEAVES = ("a_log", "dt_bias", "d_skip")
F32_SUBTREES = ("router",)


def lm_params_from_numpy(cfg, tree: dict, dtype=torch.bfloat16,
                         device=None) -> dict:
    """The JAX `repro.models.transformer.init_params` pytree, leaves as
    numpy arrays, as the port's parameters for `cfg`: the same nested
    dicts with stacked per-layer leaves. Leaves go through float32, which
    holds a bf16 value exactly (`np.asarray` of a JAX bf16 array is an
    `ml_dtypes.bfloat16` array, which `torch.from_numpy` rejects), then to
    `dtype`, or to float32 for `F32_LEAVES` and under `F32_SUBTREES`."""
    check_family(cfg)
    dev = resolve_device(device)

    def leaf(path, a):
        f32 = path[-1] in F32_LEAVES or any(k in F32_SUBTREES for k in path)
        t = torch.from_numpy(np.asarray(a, np.float32).copy())
        return t.to(device=dev, dtype=torch.float32 if f32 else dtype)

    def walk(d, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else leaf(path + (k,), v) for k, v in d.items()}
    return walk(tree)


def opt_state_from_numpy(tree: dict, device=None) -> dict:
    """An optimizer state of the JAX package — `adamw`'s {"m", "v",
    "count"} or `adafactor`'s {"stats", "count"} — leaves as numpy
    arrays, as the port's: the same nested dicts, each leaf in its own
    dtype (a bf16 leaf through float32, which holds it exactly), so both
    packages start an update from one state."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    def walk(d):
        return {k: walk(v) if isinstance(v, dict) else leaf(v)
                for k, v in d.items()}
    return walk(tree)


def cluster_state_from_numpy(d: dict) -> ClusterState:
    """`d`: `n_servers`, `cores_per_server`, `chassis_of_server`,
    `n_chassis`, and optionally the aggregates `free_cores`, `gamma_uf`,
    `gamma_nuf`, `rho_peak`, `rho_max` (fresh values when absent)."""
    aggs = {k: np.array(d[k], np.float64) for k in
            ("free_cores", "gamma_uf", "gamma_nuf", "rho_peak", "rho_max")
            if k in d}
    return ClusterState(
        n_servers=int(d["n_servers"]),
        cores_per_server=int(d["cores_per_server"]),
        chassis_of_server=np.asarray(d["chassis_of_server"], np.int64),
        n_chassis=int(d["n_chassis"]), **aggs)
