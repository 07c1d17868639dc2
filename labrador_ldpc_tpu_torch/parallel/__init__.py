"""Data parallelism over ranks (`mesh`) and the multi-process launcher
(`launch`, imported on demand: it starts process groups)."""

from .mesh import (
    BatchMesh,
    batch_sharding,
    broadcast_object,
    make_batch_mesh,
    make_sharded_bf_decoder,
    make_sharded_decoder,
    make_sharded_trial_step,
    shard_decoder,
)

__all__ = [
    "BatchMesh",
    "make_batch_mesh",
    "batch_sharding",
    "broadcast_object",
    "shard_decoder",
    "make_sharded_decoder",
    "make_sharded_bf_decoder",
    "make_sharded_trial_step",
]
