"""Elastic scaling: resume the same logical run on a different mesh, as
`repro.runtime.elastic` has it.

Checkpoints store whole (gathered) arrays (`checkpoint.checkpointer`),
so scale-up/scale-down is: build the new DeviceMesh, derive new
shardings from the same Strategy, and restore with placement. The batch
schedule is step-indexed and stateless (`data.pipeline`), so data order
is preserved regardless of the data-parallel width.
"""
from __future__ import annotations

from repro_torch.launch import sharding as shd


def reshard_plan(strategy_name: str, old_mesh, new_mesh, params_shape):
    """Shardings before/after an elastic event, for audit/logging."""
    old = shd.param_shardings(
        shd.make_strategy(strategy_name, old_mesh), old_mesh, params_shape)
    new = shd.param_shardings(
        shd.make_strategy(strategy_name, new_mesh), new_mesh, params_shape)
    return old, new


def elastic_restore(checkpointer, tree_like, strategy_name, new_mesh):
    """Restore the newest checkpoint onto `new_mesh` (different device
    count/topology than at save time): (tree of DTensors, step)."""
    strat = shd.make_strategy(strategy_name, new_mesh)
    shardings = shd.param_shardings(strat, new_mesh, tree_like)
    return checkpointer.restore(tree_like, shardings=shardings)
