"""Driver entry points of the port.

PyTorch counterpart of `__graft_entry__.py`:

entry():             (fn, args) of one decode step of the main path: TM8192,
                     B=128, 3 flipped bits a frame, `decode_ms(impl="auto")`
                     (the layered CUDA kernel on a card).
dryrun_multichip(n): n CPU ranks over Gloo run the data-parallel trial
                     steps, the sharded min-sum, sum-product and bit-flip
                     decoders, the waterfall and a checkpoint/resume cycle
                     with the batch split over them, each held equal to the
                     one-rank run; one `DRYRUN OK: ...` line per
                     configuration, ending in the `__graft_entry__.py` line
                     of the JAX configuration it stands for (`[port]` where
                     the JAX dry run has none).

    python -m labrador_ldpc_tpu_torch.entry [n_ranks]
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .codes.params import get_code
from .device import resolve_device
from .ops.convert import hard_to_llrs, unpack_bits
from .ops.encoder import encode
from .ops.minsum import decode_ms
from .parallel.launch import free_port, run_processes
from .serve import FLIPS

__all__ = ["entry", "dryrun_multichip"]

_ROOT = Path(__file__).resolve().parents[1]

# the sharded trial steps of the dry run: (code, dtype, impl, line of the JAX
# configuration in __graft_entry__.py or None); cuda_layered and cuda_qc run
# the kernels' plain versions on the CPU, sp_layered its true LLRs 2y/sigma^2
DRYRUN_STEPS = (
    ("TM2048", "float32", "qc", 109),
    ("TM2048", "float32", "layered", 109),
    ("TC128", "int8", "qc_i8", 109),
    ("TC128", "int16", "layered", None),
    ("TM1280", "float32", "cuda_layered", None),
    ("TM2048", "float32", "sp_layered", None),
    ("TM1280", "bfloat16", "cuda_qc", None),
)
# the other certified configurations: the bit-flip trial step, six sharded
# decoders, the mesh waterfall and its checkpoint/resume cycle
DRYRUN_OTHERS = 9


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


def _dryrun_rank(rank: int, n: int, port: int, work: str) -> None:
    """One rank of `dryrun_multichip`; rank 0 prints the certified lines.
    `work` is a directory every rank names (only rank 0 writes in it)."""
    import torch.distributed as dist

    from .channel.awgn import make_trial_step, quantize_llrs
    from .channel.hard import _make_bf_decoder, make_bf_trial_step
    from .channel.waterfall import _batch_generator, waterfall
    from .parallel.launch import initialize
    from .parallel.mesh import (
        make_batch_mesh, make_sharded_bf_decoder, make_sharded_decoder, make_sharded_trial_step,
    )

    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{port}", n, rank, device="cpu")
    cpu = torch.device("cpu")
    try:
        mesh = make_batch_mesh(device="cpu")
        B = 2 * n

        def ok(config: str, jax_line: int | None):
            if rank == 0:
                tag = "port" if jax_line is None else f"__graft_entry__.py:{jax_line}"
                print(f"DRYRUN OK: {config} [{tag}]", flush=True)

        def gen():
            return _batch_generator(0, 0, cpu)

        for name, dtype, impl, jax_line in DRYRUN_STEPS:
            step = make_sharded_trial_step(name, B, mesh, maxiters=2, dtype=dtype, impl=impl)
            one = make_trial_step(name, B, 2, dtype, None, impl, device="cpu")
            got, want = step(gen(), 0.5), one(gen(), 0.5)
            if [int(x) for x in got] != [int(x) for x in want] or int(got.trials) != B:
                raise AssertionError(f"{name}/{dtype}/{impl}: {got} != {want}")
            ok(f"sharded trial step {name}/{dtype}/{impl} == unsharded", jax_line)

        got = make_bf_trial_step("TM1280", B, 8, "bsc", device="cpu", mesh=mesh)(gen(), 0.01)
        want = make_bf_trial_step("TM1280", B, 8, "bsc", device="cpu")(gen(), 0.01)
        if [int(x) for x in got] != [int(x) for x in want]:
            raise AssertionError(f"bf TM1280: {got} != {want}")
        ok("sharded bit-flip trial step TM1280 bsc == unsharded", None)

        rng = np.random.default_rng(3)

        def flipped(name):
            """(B, n/8) codewords of random data, FLIPS in byte 0."""
            code = get_code(name)
            data = rng.integers(0, 256, (B, code.k // 8), dtype=np.uint8)
            cw = encode(code, torch.from_numpy(data), cpu)
            cw[:, 0] ^= FLIPS
            return cw

        def hold(label, jax_line, got, want):
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{label} differs from the unsharded decode")
            ok(f"{label} == unsharded", jax_line)

        llrs = {name: hard_to_llrs(flipped(name), torch.float32, cpu)
                for name in ("TM1280", "TM8192", "TM2048")}
        for name, dtype, impl, x, jax_line in (
            ("TM1280", "float32", "cuda_layered", llrs["TM1280"], 138),
            ("TM8192", "float32", "auto", llrs["TM8192"], 161),
            ("TM2048", "float32", "sp_layered", llrs["TM2048"] * 4.0, 185),
            ("TM1280", "int8", "cuda_layered", quantize_llrs(llrs["TM1280"], torch.int8), 205),
        ):
            got = make_sharded_decoder(name, mesh, x.dtype, maxiters=4, impl=impl)(x)
            want = decode_ms(name, x, maxiters=4, impl=impl, device=cpu)
            hold(f"sharded decoder {name}/{dtype}/{impl}", jax_line, got, want)

        # TM1280 is punctured: the erasure pass runs
        rx = unpack_bits(flipped("TM1280"), cpu)
        for impl, jax_line in (("qc", 224), ("cuda", 233)):
            got = make_sharded_bf_decoder("TM1280", mesh, maxiters=8, impl=impl)(rx)
            want = _make_bf_decoder("TM1280", 8, impl, cpu)(rx)
            hold(f"sharded bit-flip decoder TM1280/{impl}", jax_line, got, want)

        def counters(pt):
            return (pt.trials, pt.bits, pt.bit_errors, pt.frame_errors, pt.decode_failures,
                    pt.iterations)

        kw = dict(batch=B, maxiters=4, max_bits=B * 64 * 3, max_bit_errors=10**9, seed=7,
                  pipeline_depth=2, device="cpu")
        want = waterfall("TC128", [2.0], **kw)[0]
        got = waterfall("TC128", [2.0], mesh=mesh, **kw)[0]
        if counters(got) != counters(want):
            raise AssertionError(f"mesh waterfall {got} != {want}")
        ok("mesh waterfall counters == one-rank waterfall", None)

        ck = Path(work) / "mesh_sweep.ckpt"
        waterfall("TC128", [2.0], mesh=mesh, checkpoint=ck, **kw)
        if rank == 0:  # the interruption: keep the config and one drained batch
            lines = ck.read_text().splitlines()
            ck.write_text("\n".join(lines[:2]) + "\n")
        dist.barrier()
        got = waterfall("TC128", [2.0], mesh=mesh, checkpoint=ck, **kw)[0]
        if counters(got) != counters(want):
            raise AssertionError(f"resumed mesh waterfall {got} != {want}")
        ok("mesh waterfall checkpoint/resume counters == uninterrupted run", 262)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks: int = 2) -> None:
    """Spawn `n_ranks` CPU processes over Gloo and run `_dryrun_rank` in
    each; raises if a rank fails. Prints rank 0's certified lines."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = free_port()
    with tempfile.TemporaryDirectory() as work:
        outs = run_processes(
            [[sys.executable, "-c",
              f"from labrador_ldpc_tpu_torch.entry import _dryrun_rank; "
              f"_dryrun_rank({r}, {n_ranks}, {port}, {work!r})"] for r in range(n_ranks)],
            timeout=300, cwd=_ROOT, env=env)
    lines = [line for line in outs[0].splitlines() if line.startswith("DRYRUN OK: ")]
    print("\n".join(lines), flush=True)
    want = len(DRYRUN_STEPS) + DRYRUN_OTHERS
    if len(lines) != want:
        raise RuntimeError(f"dryrun_multichip: {len(lines)}/{want} configurations certified")
    print(f"dryrun_multichip: {len(lines)}/{want} configurations certified over {n_ranks} ranks")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
