"""Carry parameters and state across from plain numpy arrays.

The port never imports `repro`; a caller holding objects of the JAX
package (a trained `PredictionService`, a `SubscriptionTable`, a
`ClusterState`) hands their arrays over as dicts of numpy arrays, so
both packages compute from the same forests and aggregates.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.features import FEATURE_NAMES
from repro_torch.core.forest import ObliviousForest
from repro_torch.core.placement import ClusterState
from repro_torch.core.predictor import PredictionService, TwoStageP95Model
from repro_torch.device import resolve_device
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
