"""Online prediction-and-admission serving pipeline (paper §II-D), the
torch counterpart of `repro.serve.pipeline.ServePipeline`.

Per micro-batch, with all model operands, subscription aggregates and
cluster aggregates resident on the pipeline's device:

    featurize (serve.featurizer)  ->  four-forest inference + gating
    (serve.inference)  ->  Algorithm-1 placement with power admission
    (serve.placement / serve.admission)

`hot_swap` is the paper's daily retrain: the new forests are packed
into the standby buffer, then one flip routes the next batch to them.

This part of the port carries the synchronous `serve` path and the
chassis budget. The ingest queue (`submit`/`flush`), the emergency,
adaptive and ballooning planes, the cluster token pool and the
observability plane are later parts of the port (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.placement import SchedulerPolicy
from repro_torch.core.predictor import UF, PredictionService
from repro_torch.core.resources import ResourceVector
from repro_torch.device import resolve_device
from repro_torch.serve import admission, placement
from repro_torch.serve.featurizer import (
    SubscriptionTable, featurize_batch, ingest_population, table_from_history)
from repro_torch.serve.inference import (
    bucket_to_p95_torch, pack_service, served_query)
from repro_torch.sim.telemetry import ArrivalBatch, Population

#: PlaneBundle fields not carried yet -> the ROADMAP.md Queue 1 item that
#: ports them.
_LATER_PLANES = {
    "cluster_budget": "Queue 1 item 10 (sharded serving)",
    "emergency": "Queue 1 item 9 (online mitigation planes)",
    "adaptive": "Queue 1 item 9 (online mitigation planes)",
    "ballooning": "Queue 1 item 9 (online mitigation planes)",
    "obs": "Queue 1 item 11 (observability)",
}


@dataclass(frozen=True)
class PlaneBundle:
    """Control-plane attachments of a pipeline. This part of the port
    carries `chassis_budget` only: the per-chassis admission budget as a
    `ResourceVector` (the watts axis converts through the power model
    into the rho ceiling, cores/GB axes are ledger currency). Setting any
    other plane raises NotImplementedError naming the ROADMAP item."""
    chassis_budget: ResourceVector | None = None
    cluster_budget: object = None
    emergency: object = None
    adaptive: object = None
    ballooning: object = None
    obs: object = None

    def __post_init__(self):
        for name, item in _LATER_PLANES.items():
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"PlaneBundle.{name} is not ported yet: ROADMAP.md "
                    f"{item}")


@dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 256
    policy: SchedulerPolicy = field(default_factory=SchedulerPolicy)
    planes: PlaneBundle = field(default_factory=PlaneBundle)


@dataclass
class ServeResult:
    """Per-arrival decisions for one served batch (host arrays)."""
    server: np.ndarray              # (B,) FAIL_* codes on reject
    workload_type: np.ndarray       # (B,) post-gating UF/NUF
    p95_bucket: np.ndarray          # (B,) post-gating bucket
    p95_eff: np.ndarray             # (B,) p95 recorded into aggregates
    conservative: np.ndarray        # (B,) bool — hit a confidence gate

    @property
    def admitted(self) -> np.ndarray:
        return self.server >= 0

    @property
    def n_admitted(self) -> int:
        return int(self.admitted.sum())

    @property
    def n_capacity_rejected(self) -> int:
        return int((self.server == placement.FAIL_CAPACITY).sum())

    @property
    def n_power_rejected(self) -> int:
        return int((self.server == placement.FAIL_POWER).sum())

    @property
    def n_conservative(self) -> int:
        return int(self.conservative.sum())


def _concat_results(parts: list) -> ServeResult:
    return ServeResult(*(np.concatenate([getattr(p, f) for p in parts])
                         for f in ("server", "workload_type", "p95_bucket",
                                   "p95_eff", "conservative")))


class ServePipeline:
    """Stateful serving endpoint on the device of its state tensors. Not
    thread-safe; one instance serves one cluster."""

    def __init__(self, service: PredictionService,
                 table: SubscriptionTable,
                 state: placement.DeviceClusterState,
                 cores_per_server: int,
                 config: ServeConfig | None = None,
                 blades_per_chassis: int | None = None):
        self.config = config or ServeConfig()
        self.device = state.free_cores.device
        self.table = table
        self.state = state
        self.cores_per_server = int(cores_per_server)
        # double-buffered model: index _active serves, 1-_active packs
        self._buffers = [pack_service(service, self.device), None]
        self._active = 0
        self.n_chassis = state.rho_max.shape[0]
        if blades_per_chassis is None:
            blades_per_chassis = state.n_servers // self.n_chassis
        self.blades_per_chassis = blades_per_chassis
        # (C, R) per-chassis admission ceilings over the (watts, cores,
        # GB) ledger; an absent budget leaves every column +inf
        self.res_cap = torch.as_tensor(
            admission.resource_caps_from_budget(
                self.config.planes.chassis_budget or ResourceVector(),
                blades_per_chassis, self.n_chassis),
            dtype=state.free_cores.dtype, device=self.device)
        self.swaps = 0

    @property
    def rho_cap(self) -> torch.Tensor:
        """(C,) watt-axis admission ceiling (rho units)."""
        return self.res_cap[..., 0]

    @classmethod
    def from_history(cls, service: PredictionService, history: Population,
                     uf_labels, n_servers: int, cores_per_server: int,
                     blades_per_chassis: int,
                     table_capacity: int | None = None,
                     config: ServeConfig | None = None,
                     device=None) -> "ServePipeline":
        """Bootstrap table + empty cluster on `device` (the card unless
        ``device="cpu"``) from an offline labeled history."""
        dev = resolve_device(device)
        if table_capacity is None:
            table_capacity = max(
                (v.subscription for v in history.vms), default=0) + 1024
        labels = uf_labels.cpu().numpy() if torch.is_tensor(uf_labels) \
            else uf_labels
        table = table_from_history(history, labels, table_capacity, dev)
        state = placement.fresh_state(
            n_servers, cores_per_server,
            np.arange(n_servers) // blades_per_chassis, device=dev)
        return cls(service, table, state, cores_per_server, config=config,
                   blades_per_chassis=blades_per_chassis)

    def hot_swap(self, new_service: PredictionService) -> None:
        """Pack the retrained forests into the standby buffer, then flip.
        Calls between pack and flip keep using the old model."""
        standby = 1 - self._active
        self._buffers[standby] = pack_service(new_service, self.device)
        self._active = standby
        self.swaps += 1

    def observe(self, history: Population, uf_labels) -> None:
        """Fold freshly labeled telemetry into the subscription
        aggregates."""
        self.table = ingest_population(self.table, history, uf_labels)

    def serve(self, batch: ArrivalBatch) -> ServeResult:
        """Serve one batch synchronously, in micro-batches of the
        configured size."""
        bs = self.config.batch_size
        if len(batch) <= bs:
            return self._serve_padded(batch)
        parts = [ArrivalBatch(*(getattr(batch, f)[i:i + bs]
                                for f in ArrivalBatch.__dataclass_fields__))
                 for i in range(0, len(batch), bs)]
        return _concat_results([self._serve_padded(p) for p in parts])

    def _serve_padded(self, batch: ArrivalBatch) -> ServeResult:
        b = len(batch)
        pad_to = self.config.batch_size
        packed, meta = self._buffers[self._active]
        x = featurize_batch(self.table, batch, pad_to=pad_to)
        q = served_query(packed, meta, x)
        is_uf = q["workload_type_used"] == UF
        if self.config.policy.use_utilization_predictions:
            p95_eff = bucket_to_p95_torch(q["p95_bucket_used"])
        else:
            p95_eff = torch.ones(pad_to, dtype=torch.float32,
                                 device=self.device)

        def padded(a):
            out = np.zeros(pad_to, np.float32)
            out[:b] = a
            return torch.as_tensor(out, device=self.device)
        valid = torch.arange(pad_to, device=self.device) < b
        servers = self._place(padded(batch.cores), is_uf, p95_eff, valid,
                              padded(batch.memory_gb))
        host = [a[:b].cpu().numpy() for a in (
            servers, q["workload_type_used"], q["p95_bucket_used"],
            p95_eff, q["conservative"])]
        return ServeResult(*host)

    def _place(self, cores, is_uf, p95_eff, valid, mem):
        """Placement stage of one padded micro-batch: Algorithm 1 with
        power admission against the cluster state; returns the (B,)
        decisions (FAIL_* codes on reject)."""
        self.state, servers = placement.place_batch(
            self.state, cores, is_uf, p95_eff, valid, self.res_cap,
            self.config.policy, self.cores_per_server, mem_gb=mem)
        return servers

    def depart(self, servers, cores, p95_eff, is_uf, mem_gb=None) -> None:
        """Release departed VMs' aggregates (batched, order-free)."""
        self.state = placement.remove_batch(self.state, servers, cores,
                                            p95_eff, is_uf, mem_gb=mem_gb)
