"""Online prediction-and-admission serving pipeline, the torch
counterpart of `repro.serve`: featurization, four-forest inference with
confidence gating, Algorithm-1 placement and power admission, with all
state resident on the pipeline's device."""
from repro_torch.core.resources import RESOURCES, ResourceVector
from repro_torch.serve.admission import (
    headroom_w, projected_chassis_power, resource_caps_from_budget,
    rho_cap_from_budget)
from repro_torch.serve.featurizer import (
    SubscriptionTable, empty_table, featurize, featurize_batch,
    ingest_population, p95_bucket_torch, table_from_history, update_table)
from repro_torch.serve.inference import (
    ForestMeta, PackedForest, PackedService, ServiceMeta, bucket_to_p95_torch,
    pack_service, resolve_kernel, served_query)
from repro_torch.serve.pipeline import (
    PlaneBundle, ServeConfig, ServePipeline, ServeResult)
from repro_torch.serve.placement import (
    FAIL_CAPACITY, FAIL_POWER, FAIL_TOKENS, DeviceClusterState, device_state,
    fresh_state, outcome_counters, place_batch, remove_batch,
    score_chassis_batch, score_server_batch)

__all__ = [
    "RESOURCES", "ResourceVector",
    "headroom_w", "projected_chassis_power", "resource_caps_from_budget",
    "rho_cap_from_budget",
    "SubscriptionTable", "empty_table", "featurize", "featurize_batch",
    "ingest_population", "p95_bucket_torch", "table_from_history",
    "update_table",
    "ForestMeta", "PackedForest", "PackedService", "ServiceMeta",
    "bucket_to_p95_torch", "pack_service", "resolve_kernel", "served_query",
    "PlaneBundle", "ServeConfig", "ServePipeline", "ServeResult",
    "FAIL_CAPACITY", "FAIL_POWER", "FAIL_TOKENS", "DeviceClusterState",
    "device_state", "fresh_state", "outcome_counters", "place_batch",
    "remove_batch", "score_chassis_batch", "score_server_batch",
]
