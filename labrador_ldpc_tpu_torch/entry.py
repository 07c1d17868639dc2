"""Driver entry points of the port.

PyTorch counterpart of `__graft_entry__.py`:

entry():             (fn, args) of one decode step of the main path: TM8192,
                     B=128, 3 flipped bits a frame, `decode_ms(impl="auto")`
                     (the layered CUDA kernel on a card).
dryrun_multichip(n): n CPU ranks over Gloo run the data-parallel trial
                     steps, the sharded decoder and the waterfall with the
                     batch split over them, each held equal to the one-rank
                     run; one `DRYRUN OK: ...` line per configuration.

    python -m labrador_ldpc_tpu_torch.entry [n_ranks]
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .codes.params import get_code
from .device import resolve_device
from .ops.convert import hard_to_llrs
from .ops.encoder import encode
from .ops.minsum import decode_ms
from .serve import FLIPS

__all__ = ["entry", "dryrun_multichip"]

_ROOT = Path(__file__).resolve().parents[1]

# the sharded trial steps of the dry run: (code, dtype, impl); cuda_layered
# runs the kernel's plain version on the CPU
DRYRUN_STEPS = (
    ("TM2048", "float32", "qc"),
    ("TM2048", "float32", "layered"),
    ("TC128", "int8", "qc_i8"),
    ("TM1280", "float32", "cuda_layered"),
)


def entry(device="cuda"):
    """Return (fn, example_args): one TM8192 decode of 128 frames with 3
    flipped bits each, through `decode_ms(impl="auto")`, maxiters 50."""
    code = get_code("TM8192")
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, 256, (128, code.k // 8), dtype=np.uint8))
    cw = encode(code, data.to(dev), dev)
    cw[:, 0] ^= FLIPS
    llrs = hard_to_llrs(cw, torch.float32, dev)

    def fn(x):
        return decode_ms(code, x, maxiters=50, impl="auto", device=dev)

    return fn, (llrs,)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dryrun_rank(rank: int, n: int, port: int) -> None:
    """One rank of `dryrun_multichip`; rank 0 prints the certified lines."""
    import torch.distributed as dist

    from .channel.awgn import make_trial_step
    from .channel.hard import make_bf_trial_step
    from .channel.waterfall import _batch_generator, waterfall
    from .parallel.launch import initialize
    from .parallel.mesh import make_batch_mesh, make_sharded_decoder, make_sharded_trial_step

    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{port}", n, rank, device="cpu")
    cpu = torch.device("cpu")
    try:
        mesh = make_batch_mesh(device="cpu")
        B = 2 * n

        def ok(config: str):
            if rank == 0:
                print(f"DRYRUN OK: {config}", flush=True)

        def gen():
            return _batch_generator(0, 0, cpu)

        for name, dtype, impl in DRYRUN_STEPS:
            step = make_sharded_trial_step(name, B, mesh, maxiters=2, dtype=dtype, impl=impl)
            one = make_trial_step(name, B, 2, dtype, None, impl, device="cpu")
            got, want = step(gen(), 0.5), one(gen(), 0.5)
            if [int(x) for x in got] != [int(x) for x in want] or int(got.trials) != B:
                raise AssertionError(f"{name}/{dtype}/{impl}: {got} != {want}")
            ok(f"sharded trial step {name}/{dtype}/{impl} == unsharded")

        got = make_bf_trial_step("TM1280", B, 8, "bsc", device="cpu", mesh=mesh)(gen(), 0.01)
        want = make_bf_trial_step("TM1280", B, 8, "bsc", device="cpu")(gen(), 0.01)
        if [int(x) for x in got] != [int(x) for x in want]:
            raise AssertionError(f"bf TM1280: {got} != {want}")
        ok("sharded bit-flip trial step TM1280 bsc == unsharded")

        for name, impl in (("TM1280", "cuda_layered"), ("TM8192", "auto")):
            code = get_code(name)
            rng = np.random.default_rng(3)
            data = torch.from_numpy(rng.integers(0, 256, (B, code.k // 8), dtype=np.uint8))
            cw = encode(code, data, cpu)
            cw[:, 0] ^= FLIPS
            llrs = hard_to_llrs(cw, torch.float32, cpu)
            got = make_sharded_decoder(code, mesh, maxiters=4, impl=impl)(llrs)
            want = decode_ms(code, llrs, maxiters=4, impl=impl, device=cpu)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"sharded decoder {name}/{impl} differs from unsharded")
            ok(f"sharded decoder {name}/{impl} == unsharded")

        kw = dict(batch=B, maxiters=4, max_bits=B * 64 * 3, max_bit_errors=10**9, seed=7,
                  pipeline_depth=2, device="cpu")
        got = waterfall("TC128", [2.0], mesh=mesh, **kw)[0]
        want = waterfall("TC128", [2.0], **kw)[0]
        if (got.trials, got.bit_errors, got.frame_errors, got.iterations) != \
                (want.trials, want.bit_errors, want.frame_errors, want.iterations):
            raise AssertionError(f"mesh waterfall {got} != {want}")
        ok("mesh waterfall counters == one-rank waterfall")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks: int = 2) -> None:
    """Spawn `n_ranks` CPU processes over Gloo and run `_dryrun_rank` in
    each; raises if a rank fails. Prints rank 0's certified lines."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c",
             f"from labrador_ldpc_tpu_torch.entry import _dryrun_rank; "
             f"_dryrun_rank({r}, {n_ranks}, {port})"],
            cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n_ranks)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise RuntimeError(f"dry-run rank failed (exit {p.returncode}):\n{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = [line for line in outs[0].splitlines() if line.startswith("DRYRUN OK: ")]
    print("\n".join(lines), flush=True)
    want = len(DRYRUN_STEPS) + 4
    if len(lines) != want:
        raise RuntimeError(f"dryrun_multichip: {len(lines)}/{want} configurations certified")
    print(f"dryrun_multichip: {len(lines)}/{want} configurations certified over {n_ranks} ranks")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
