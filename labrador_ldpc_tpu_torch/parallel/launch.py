"""Multi-process execution: process-group bootstrap and the waterfall split
over ranks.

PyTorch counterpart of `labrador_ldpc_tpu/parallel/launch.py`. Every process
calls `initialize` (a thin wrapper over `torch.distributed.init_process_group`),
after which `parallel.make_batch_mesh()` spans all its ranks; the trial
pipeline is the one-process one (`channel.awgn.make_trial_step`), the batch
split over the ranks and the counters summed with `all_reduce`, so every
process sees the same global statistics: the cross-process form of the
perftest's AtomicU64 merge (perftest/src/main.rs:42-49).

One command a rank, e.g. on a host with four cards:

    python -m labrador_ldpc_tpu_torch.parallel.launch \\
        --coordinator host0:29500 --num-processes 4 --process-id $i \\
        --code TM8192 --snrs 1.0,1.1,1.2

or under torchrun (`--nproc-per-node 4`, no `--coordinator`: the process
group reads MASTER_ADDR, RANK and WORLD_SIZE, and each rank takes card
LOCAL_RANK). On the CPU, two ranks over Gloo:

    python -m labrador_ldpc_tpu_torch.parallel.launch --device cpu \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0 \\
        --code TC128 --snrs 2.0,4.0 --batch 32 --max-bits 4096 &
    python -m labrador_ldpc_tpu_torch.parallel.launch --device cpu \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 1 \\
        --code TC128 --snrs 2.0,4.0 --batch 32 --max-bits 4096

Only rank 0 prints the CSV rows. With `distributed_waterfall(...,
checkpoint=path)` every rank names the same file and rank 0 alone reads and
writes it (`channel.waterfall`). Nothing here runs at import.

`--impl` defaults to "auto" (the layered CUDA kernel on a card, the plain
layered decoder on the CPU), where the JAX launcher defaults to "qc"
(labrador_ldpc_tpu/parallel/launch.py:104): on a card the port's "qc" is
the plain PyTorch flooding decoder, not a kernel. So the same command line
runs the layered schedule here and the flooding one there, and their curves
differ; pass `--impl cuda_qc` for the flooding schedule on the card.
"""

from __future__ import annotations

import argparse
import datetime
import socket
import subprocess
import sys

import torch.distributed as dist

from ..device import resolve_device

__all__ = ["initialize", "distributed_waterfall", "free_port", "run_processes", "main"]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device="cuda",
    timeout: float | None = None,
) -> None:
    """Join this process to the default process group.

    With `coordinator_address` ("host:port" of rank 0's store), pass the
    process count and this process's rank; without it the group is read
    from the environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, as
    torchrun sets them). `backend` defaults to "nccl" for CUDA and "gloo"
    for the CPU; "gloo" on CUDA puts several ranks on one card (NCCL
    refuses two ranks on one device), its collectives on host copies.

    `timeout` (seconds) bounds the wait for the other ranks, at the start and
    in every collective; None keeps PyTorch's default (10 minutes for NCCL,
    30 for Gloo). A rank that dies leaves the others in their next
    collective: past the timeout Gloo raises there and NCCL's watchdog ends
    the process.
    """
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        **({} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}),
    )


def distributed_waterfall(csv_out=None, verbose: bool = False, device="cuda", **kwargs):
    """Run `channel.waterfall` with the batch split over every rank of the
    default process group. Requires `initialize` first. `batch` (in kwargs)
    is the global batch and must divide by the ranks. Every rank returns the
    same list of SnrPoint; only rank 0 writes `csv_out` and `verbose`."""
    from ..channel.waterfall import waterfall
    from .mesh import make_batch_mesh

    mesh = make_batch_mesh(device=device)
    return waterfall(mesh=mesh, csv_out=csv_out, verbose=verbose, device=mesh.device, **kwargs)


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now, for a process group's store."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(argvs, timeout: float, **popen_kwargs) -> list[str]:
    """Start one process for each argument list, all at once (the ranks of
    one group must run together), wait for each in turn and return their
    standard outputs. Raises RuntimeError, with the end of its standard
    error, for the first that exits non-zero; kills whichever still run when
    it returns or raises (subprocess.TimeoutExpired past `timeout` seconds
    for one process)."""
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              **popen_kwargs) for argv in argvs]
    outs = []
    try:
        for argv, proc in zip(argvs, procs):
            out, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(f"{' '.join(map(str, argv))[:200]} exited "
                                   f"{proc.returncode}:\n{err[-3000:]}")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="labrador_ldpc_tpu_torch.parallel.launch",
        description="BER waterfall split over ranks (run one instance per rank)",
    )
    ap.add_argument("--coordinator", default=None, help="rank 0's host:port")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="default: nccl for cuda, gloo for cpu")
    ap.add_argument("--code", default="TM8192")
    ap.add_argument("--snrs", required=True, help="comma-separated list (dB, or p for bsc/bec)")
    ap.add_argument("--batch", type=int, default=8192, help="GLOBAL batch")
    ap.add_argument("--maxiters", type=int, default=100)
    ap.add_argument("--max-bits", type=int, default=50_000_000)
    ap.add_argument("--max-bit-errors", type=int, default=5_000)
    ap.add_argument("--noise-model", choices=["perftest", "ebn0", "bsc", "bec"],
                    default="perftest")
    ap.add_argument("--decoder", choices=["ms", "ms_hard", "bf"], default="ms")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--llr-scale", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    initialize(args.coordinator, args.num_processes, args.process_id, args.backend, args.device)
    try:
        distributed_waterfall(
            code=args.code,
            snrs_db=[float(s) for s in args.snrs.split(",")],
            batch=args.batch,
            maxiters=args.maxiters,
            max_bits=args.max_bits,
            max_bit_errors=args.max_bit_errors,
            noise_model=args.noise_model,
            dtype_name=args.dtype,
            alpha=args.alpha,
            impl=args.impl,
            llr_scale=args.llr_scale,
            seed=args.seed,
            csv_out=sys.stdout,
            verbose=args.verbose,
            decoder=args.decoder,
            device=args.device,
        )
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
