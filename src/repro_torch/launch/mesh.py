"""Meshes, as `repro.launch.mesh` has them: the production topology, a
small debug mesh and the axes the global batch shards over.

`MeshSpec` is the abstract mesh the sharding rules read: axis names and
sizes, nothing else. `make_production_mesh` and `make_debug_mesh` build a
real `torch.distributed.DeviceMesh` over the process group that is up (a
fake group of the mesh's size for the dry-run, gloo on the CPU, NCCL on
the card), with `mesh_dim_names` ("data", "model") or ("pod", "data",
"model"). They are functions, never module constants: a mesh needs its
process group first.

The production shapes are the reference's target topology: (16, 16) for
one pod, (2, 16, 16) for two.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclass(frozen=True)
class MeshSpec:
    """Axis names and sizes; `.shape` maps a name to its size and
    `.axis_names` lists the names in mesh order, as a jax Mesh has
    them."""
    sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def mesh_spec(mesh) -> MeshSpec:
    """The `MeshSpec` of a DeviceMesh (or of a MeshSpec, itself)."""
    if isinstance(mesh, MeshSpec):
        return mesh
    return MeshSpec(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def production_spec(multi_pod: bool = False) -> MeshSpec:
    return MeshSpec(*PRODUCTION[multi_pod])


def debug_spec(n_data: int = 2, n_model: int = 2,
               multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec((2, n_data, n_model), ("pod", "data", "model"))
    return MeshSpec((n_data, n_model), ("data", "model"))


def build_mesh(spec: MeshSpec, device=None):
    """A DeviceMesh of `spec`'s shape over ranks 0..size-1 of the
    process group that is up, on `device`'s type (`None`: the card)."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    ranks = torch.arange(spec.size).reshape(spec.sizes)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=spec.axis_names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks."""
    return build_mesh(production_spec(multi_pod), device)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    multi_pod: bool = False, device=None):
    """Small mesh for the multi-rank tests (4 or 8 ranks)."""
    return build_mesh(debug_spec(n_data, n_model, multi_pod), device)


def data_axes(mesh) -> tuple:
    """Axes the global batch shards over."""
    return ("pod", "data") if "pod" in mesh_spec(mesh).axis_names \
        else ("data",)
