"""Data parallelism over ranks: the batch split, counters summed across them.

PyTorch counterpart of `labrador_ldpc_tpu/parallel/mesh.py`. The reference
library's only concurrency is the perftest's thread pool with an AtomicU64
counter merge (perftest/src/main.rs:39-49); the JAX package shards the
codeword batch over a 1-D device mesh and sums the counters with psum. Here
a mesh is the ranks of a `torch.distributed` process group, one process a
rank: each rank decodes its rows of the global batch on its own device, and
the counters are summed with one `all_reduce`, the decoded rows gathered
with `all_gather_into_tensor`. A codeword is at most 10,240 LLRs, so the
batch is the only dimension to split.

A single process with no process group is a mesh of one rank. Under the
Gloo backend the collectives run on host copies of CUDA tensors (Gloo's
collectives are host collectives); NCCL runs them on the card.

On a mesh with a process group each collective is a span (`utils.tracing`:
`ldpc.all_reduce`, `ldpc.all_gather`, `ldpc.broadcast`, args bytes), host
copies included, and is counted by kind in `collective_calls` and
`collective_bytes`: the bytes of the tensor this rank contributes (for a
broadcast, of rank 0's pickled object). A mesh of one rank returns before
either, so it pays nothing; nothing here resets the counters.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from ..utils.tracing import span

__all__ = [
    "BatchMesh",
    "make_batch_mesh",
    "batch_sharding",
    "broadcast_object",
    "shard_decoder",
    "make_sharded_decoder",
    "make_sharded_bf_decoder",
    "make_sharded_trial_step",
    "collective_calls",
    "collective_bytes",
]

# collectives of meshes with a process group since import, by kind; read
# and reset as `mesh.collective_calls` and `mesh.collective_bytes`
collective_calls = dict.fromkeys(("all_reduce", "all_gather", "broadcast"), 0)
collective_bytes = dict.fromkeys(collective_calls, 0)


def _count(kind: str, n: int) -> None:
    collective_calls[kind] += 1
    collective_bytes[kind] += n


@dataclass(frozen=True)
class BatchMesh:
    """This process's place among the ranks that split a batch."""

    rank: int
    world_size: int
    device: torch.device  # the device this rank decodes on
    group: object = None  # the process group; None: the default group
    backend: str | None = None  # the group's backend; None: no process group


def make_batch_mesh(group=None, device="cuda") -> BatchMesh:
    """The mesh of `group` (the default process group when None) for this
    process. A CUDA rank takes card LOCAL_RANK modulo the cards present
    (LOCAL_RANK defaults to the rank) and makes it the current card, so
    ranks may share one card. Without an initialized process group the mesh
    is this process alone."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        backend = dist.get_backend(group)
    else:
        if group is not None:
            raise ValueError("a process group was given, but torch.distributed is not initialized")
        rank, world, backend = 0, 1, None
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)  # NCCL builds its communicator on the current card
    return BatchMesh(rank, world, dev, group, backend)


def batch_sharding(mesh: BatchMesh, batch: int) -> slice:
    """This rank's rows of a global batch of `batch` codewords."""
    if batch % mesh.world_size:
        raise ValueError(f"the global batch {batch} does not divide by the {mesh.world_size} "
                         "ranks of the mesh")
    per = batch // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _on_host(mesh: BatchMesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type != "cpu"


def all_reduce_sum(mesh: BatchMesh, t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the mesh's ranks, in place (on a host copy under
    Gloo); `t` itself with one rank and no process group."""
    if mesh.backend is None:
        return t
    n = t.nbytes
    _count("all_reduce", n)
    with span("ldpc.all_reduce", "bytes", n):
        x = t.cpu() if _on_host(mesh, t) else t
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
        return x.to(t.device)


def all_gather_rows(mesh: BatchMesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `t`, concatenated in rank order."""
    if mesh.backend is None:
        return t
    n = t.nbytes
    _count("all_gather", n)
    with span("ldpc.all_gather", "bytes", n):
        x = t.cpu() if _on_host(mesh, t) else t
        out = torch.empty((mesh.world_size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
        return out.to(t.device)


def broadcast_object(mesh: BatchMesh, obj):
    """Rank 0's `obj` on every rank (one `broadcast_object_list`; pickled, so
    only for objects this program made); `obj` itself with one rank and no
    process group. Under NCCL the pickled bytes travel on the rank's card,
    which `make_batch_mesh` made current; under Gloo on the host."""
    if mesh.backend is None:
        return obj
    box = [obj]
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    with span("ldpc.broadcast"):
        dist.broadcast_object_list(box, src=src, group=mesh.group)
    _count("broadcast", len(pickle.dumps(box[0])))
    return box[0]


def shard_decoder(decoder, mesh: BatchMesh):
    """Split a batched decoder over the mesh's ranks.

    Counterpart of the JAX `channel.awgn.shard_map_decoder`, which needs a
    `result_type` because shard_map fixes its outputs before it traces; here
    the result is in hand, and keeps its type. `decoder` is any fn(x: (B, n))
    -> a (success, iterations, bits) NamedTuple, an `MSResult` or an
    `ops.bitflip.BFResult`. Returns fn(x: the GLOBAL (B, n) input) -> the
    same type for the whole batch, on every rank: each rank decodes its rows
    (`batch_sharding`) on its device, and the three fields are gathered in
    rank order (success as uint8). B must divide by the ranks.
    """

    def decode(x):
        x = torch.as_tensor(x, device=mesh.device)
        res = decoder(x[batch_sharding(mesh, x.shape[0])])
        return res._replace(
            success=all_gather_rows(mesh, res.success.to(torch.uint8)).bool(),
            iterations=all_gather_rows(mesh, res.iterations),
            bits=all_gather_rows(mesh, res.bits),
        )

    return decode


def make_sharded_decoder(
    code: LDPCCode | str,
    mesh: BatchMesh,
    dtype: torch.dtype = torch.float32,
    maxiters: int = 20,
    alpha: float | None = None,
    impl: str = "auto",
):
    """Batched min-sum or sum-product decoder with the batch split over the
    mesh's ranks: `shard_decoder` over `channel.awgn`'s decoder of `impl`.

    Returns fn(llrs: the GLOBAL (B, n) LLRs) -> MSResult of the whole batch,
    on every rank. `impl` is resolved for the mesh's device before the
    decoder is built ("auto" is the layered CUDA kernel on a card), as
    `channel.awgn.resolve_impl`.
    """
    from ..channel.awgn import _make_decoder, resolve_impl

    code = get_code(code)
    impl = resolve_impl(code, dtype, impl, mesh.device)
    return shard_decoder(_make_decoder(code, dtype, maxiters, alpha, impl, mesh.device), mesh)


def make_sharded_bf_decoder(
    code: LDPCCode | str,
    mesh: BatchMesh,
    maxiters: int = 20,
    impl: str = "auto",
):
    """Batched bit-flip decoder with the batch split over the mesh's ranks.

    Returns fn(hard_bits: the GLOBAL (B, n) 0/1 bits) -> BFResult of the
    whole batch, on every rank. `impl` as `channel.hard.resolve_bf_impl`:
    "auto" is the CUDA kernel ("cuda", `ops/cuda_bf.py`) on a card and the
    plain QC decoder on the CPU.
    """
    from ..channel.hard import _make_bf_decoder

    return shard_decoder(_make_bf_decoder(get_code(code), maxiters, impl, mesh.device), mesh)


def make_sharded_trial_step(
    code: LDPCCode | str,
    global_batch: int,
    mesh: BatchMesh,
    maxiters: int = 100,
    dtype: torch.dtype | str = torch.float32,
    alpha: float | None = None,
    impl: str = "auto",
    llr_scale: float | None = None,
):
    """End-to-end channel trial step with the batch split over the mesh.

    Returns fn(gen, sigma) -> ChannelStats of the whole `global_batch`, the
    same on every rank. A thin wrapper over `channel.awgn.make_trial_step(...,
    mesh=mesh)`, which holds the one definition of the trial pipeline.
    """
    from ..channel.awgn import make_trial_step

    name = dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")
    return make_trial_step(get_code(code), global_batch, maxiters, name, alpha, impl, llr_scale,
                           mesh.device, mesh=mesh)
