"""Data parallelism over ranks (`mesh`) and the multi-process launcher
(`launch`, imported on demand: it starts process groups)."""

from .mesh import (
    BatchMesh,
    batch_sharding,
    make_batch_mesh,
    make_sharded_decoder,
    make_sharded_trial_step,
)

__all__ = [
    "BatchMesh",
    "make_batch_mesh",
    "batch_sharding",
    "make_sharded_decoder",
    "make_sharded_trial_step",
]
