"""Online prediction-and-admission serving pipeline, the torch
counterpart of `repro.serve`: featurization, four-forest inference with
confidence gating, Algorithm-1 placement and power admission, with all
state resident on the pipeline's device; the per-host ingest merge, the
power-emergency plane, the ballooning rung, migration planning, the
adaptive oversubscription controller, and sharded serving under the
reserve/commit token protocol, the shards as a batch axis or one a device
on a mesh."""
from repro_torch.core.resources import (RESOURCES, ResourceVector,
                                        demand_vector, trough_ratios)
from repro_torch.serve.adaptive import (
    REASON_NAMES, AdaptiveConfig, AdaptiveOutputs, AdaptiveState,
    adaptive_step, adaptive_step_np, decision_reason, gate_ratio_on_stale,
    init_adaptive, init_adaptive_np, offered_power, retarget_pool)
from repro_torch.serve.admission import (
    headroom_w, projected_chassis_power, resource_caps_from_budget,
    rho_cap_from_budget)
from repro_torch.serve.ballooning import (
    BalloonOutputs, BalloonState, BallooningConfig, balloon_demand_w,
    balloon_demand_w_np, balloon_step, balloon_step_np, init_ballooning,
    init_ballooning_np, total_ballooned_gb)
from repro_torch.serve.emergency import (
    CRIT_NUF, CRIT_UF, N_LEVELS, EmergencyConfig, EmergencyOutputs,
    EmergencyState, chassis_rho_levels, chassis_rho_levels_np,
    emergency_step, emergency_step_np, init_emergency, init_emergency_np,
    masked_step, masked_step_np, mitigation_due, mitigation_due_np,
    reset_dwell, reset_dwell_np, sampled_power, sampled_power_np,
    scatter_samples, scatter_samples_np, throttled_by_level,
    util_from_power, util_from_power_np)
from repro_torch.serve.featurizer import (
    ShardedTable, SubscriptionTable, empty_table, featurize, featurize_batch,
    ingest_population, p95_bucket_torch, shard_table, table_from_history,
    update_table)
from repro_torch.serve.inference import (
    ForestMeta, PackedForest, PackedService, ServiceMeta, bucket_to_p95_torch,
    pack_service, resolve_kernel, served_query)
from repro_torch.serve.ingest import (
    ARRIVAL, CAPPING, DEPARTURE, CapBatch, DepartureBatch, HostQueue,
    IngestMux, MergedEvents, empty_arrivals, empty_caps, empty_departures,
    kway_merge, slice_soa)
from repro_torch.serve.mitigation import (LiveVMs, MigrationPlan,
                                          plan_migrations)
from repro_torch.serve.pipeline import (
    PlaneBundle, ServeConfig, ServePipeline, ServeResult, ShardedServeConfig,
    ShardedServePipeline)
from repro_torch.serve.placement import (
    FAIL_CAPACITY, FAIL_POWER, FAIL_TOKENS, DeviceClusterState, SweepCounters,
    device_state, fresh_state, outcome_counters, place_batch,
    place_batch_caps, place_batch_pooled, remove_batch, score_chassis_batch,
    score_server_batch)
from repro_torch.serve.sharding import (
    ShardedState, apply_adaptive_sharded, apply_caps_ballooned_sharded,
    apply_caps_sharded, chassis_to_shard, consume_departures,
    device_put_sharded_state, init_adaptive_sharded, init_ballooning_sharded,
    init_emergency_sharded, place_group_sharded, remove_sharded,
    resource_pool_from_budget, rho_pool_from_budget, route_shard, shard_mesh,
    shard_state, split_caps, split_departures, unshard_state)

__all__ = [
    "RESOURCES", "ResourceVector", "demand_vector", "trough_ratios",
    "REASON_NAMES", "AdaptiveConfig", "AdaptiveOutputs", "AdaptiveState",
    "adaptive_step", "adaptive_step_np", "decision_reason",
    "gate_ratio_on_stale", "init_adaptive", "init_adaptive_np",
    "offered_power", "retarget_pool",
    "BalloonOutputs", "BalloonState", "BallooningConfig", "balloon_demand_w",
    "balloon_demand_w_np", "balloon_step", "balloon_step_np",
    "init_ballooning", "init_ballooning_np", "total_ballooned_gb",
    "headroom_w", "projected_chassis_power", "resource_caps_from_budget",
    "rho_cap_from_budget",
    "CRIT_NUF", "CRIT_UF", "N_LEVELS", "EmergencyConfig",
    "EmergencyOutputs", "EmergencyState", "chassis_rho_levels",
    "chassis_rho_levels_np", "emergency_step", "emergency_step_np",
    "init_emergency", "init_emergency_np", "masked_step", "masked_step_np",
    "mitigation_due", "mitigation_due_np", "reset_dwell", "reset_dwell_np",
    "sampled_power", "sampled_power_np", "scatter_samples",
    "scatter_samples_np", "throttled_by_level", "util_from_power",
    "util_from_power_np",
    "ShardedTable", "SubscriptionTable", "empty_table", "featurize",
    "featurize_batch", "ingest_population", "p95_bucket_torch",
    "shard_table", "table_from_history", "update_table",
    "ForestMeta", "PackedForest", "PackedService", "ServiceMeta",
    "bucket_to_p95_torch", "pack_service", "resolve_kernel", "served_query",
    "ARRIVAL", "DEPARTURE", "CAPPING", "CapBatch", "DepartureBatch",
    "HostQueue", "IngestMux", "MergedEvents", "empty_arrivals",
    "empty_caps", "empty_departures", "kway_merge", "slice_soa",
    "LiveVMs", "MigrationPlan", "plan_migrations",
    "PlaneBundle", "ServeConfig", "ServePipeline", "ServeResult",
    "ShardedServeConfig", "ShardedServePipeline",
    "FAIL_CAPACITY", "FAIL_POWER", "FAIL_TOKENS", "DeviceClusterState",
    "SweepCounters", "device_state", "fresh_state", "outcome_counters",
    "place_batch", "place_batch_caps", "place_batch_pooled", "remove_batch",
    "score_chassis_batch", "score_server_batch",
    "ShardedState", "apply_adaptive_sharded", "apply_caps_ballooned_sharded",
    "apply_caps_sharded", "chassis_to_shard", "consume_departures",
    "device_put_sharded_state", "init_adaptive_sharded",
    "init_ballooning_sharded", "init_emergency_sharded",
    "place_group_sharded", "remove_sharded", "resource_pool_from_budget",
    "rho_pool_from_budget", "route_shard", "shard_mesh", "shard_state",
    "split_caps", "split_departures", "unshard_state",
]
