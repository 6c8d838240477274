"""Elastic scaling: restore any checkpoint onto any mesh.

Port of ``repro.distributed.elastic``. Checkpoints hold whole host arrays
(never a rank's part), so re-scaling a job is: build the new mesh, then
give each rank its part of every leaf by the same placement rules at
restore. An axis that no longer divides falls back to replication, as in
``distributed.sharding``: the job runs, with less parallelism on that
leaf.
"""
from __future__ import annotations

from typing import Any

from repro_torch.checkpoint.checkpointer import Checkpointer

PyTree = Any


def restore_onto_mesh(ckpt: Checkpointer, step: int, like: PyTree,
                      mesh) -> PyTree:
    """Elastic restore: this rank's part of checkpoint ``step`` on
    ``mesh``, in the structure of ``like`` (a compressed checkpoint needs
    no template: ``like`` None)."""
    if like is None:
        return ckpt.restore_compressed(step, mesh=mesh)
    return ckpt.restore(step, like, mesh=mesh)


def rescale_plan(old_mesh_shape: dict, new_mesh_shape: dict,
                 global_batch: int) -> dict:
    """Operator-facing summary of what changes when re-meshing: the
    data-parallel degree rescales the per-replica batch; a model-parallel
    change re-partitions weights (free at restore); a shrink that breaks
    divisibility is reported so the operator can adjust the global
    batch."""
    def dp(shape):
        return shape.get("pod", 1) * shape.get("data", 1)

    old_dp, new_dp = dp(old_mesh_shape), dp(new_mesh_shape)
    return {
        "old_dp": old_dp, "new_dp": new_dp,
        "old_tp": old_mesh_shape.get("model", 1),
        "new_tp": new_mesh_shape.get("model", 1),
        "batch_divisible": global_batch % new_dp == 0,
        "per_replica_batch": global_batch // new_dp
        if global_batch % new_dp == 0 else None,
    }
