"""BER/FER waterfall sweep runner.

PyTorch counterpart of `labrador_ldpc_tpu/channel/waterfall.py`, itself the
batched form of the reference perftest harness (perftest/src/main.rs:34-70):
per SNR point, run decode trials until a bit budget or a bit-error budget is
hit, then report CSV rows in the perftest schema
(`code,snr,trials,bits,errors,ber`, main.rs:62).

Randomness: the i-th batch of a sweep (counted across all its points, in
launch order, which is also drain order) draws from a `torch.Generator`
seeded by (seed, i) alone, so a resumed sweep continues the same stream. The
streams are PyTorch's (per device type), not `jax.random`'s: the counters
match the JAX package's statistically, not trial for trial.

With a mesh (`parallel.mesh.BatchMesh`) the batch is split over the mesh's
ranks and every batch's counters are summed over them (`awgn.TrialStep`), so
every rank reads the same global counters and takes the same stopping
decision at the same batch; only rank 0 writes `csv_out`, `verbose` and the
checkpoint (`_Checkpoint`).
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np
import torch

from ..codes.params import LDPCCode, get_code
from ..device import resolve_device
from ..parallel.mesh import BatchMesh, broadcast_object
from ..utils.tracing import span, spanned
from .awgn import make_trial_step, noise_sigma

__all__ = ["SnrPoint", "waterfall", "DEFAULT_SNRS_TC512"]

# reference sweep: TC512 at 0.8..2.2 dB step 0.1 (perftest/src/main.rs:67-70)
DEFAULT_SNRS_TC512 = [round(0.8 + 0.1 * i, 1) for i in range(15)]

# noise models each decode surface takes: "bsc"/"bec" sweep probabilities,
# the others dB
_NOISE_MODELS = {
    "ms": ("perftest", "ebn0"),
    "ms_hard": ("bsc", "perftest", "ebn0"),
    "bf": ("bsc", "bec", "perftest", "ebn0"),
}


@dataclass
class SnrPoint:
    code: str
    snr_db: float
    trials: int = 0
    bits: int = 0
    bit_errors: int = 0
    frame_errors: int = 0
    decode_failures: int = 0
    iterations: int = 0
    elapsed_s: float = 0.0

    @property
    def ber(self) -> float:
        return self.bit_errors / self.bits if self.bits else 0.0

    @property
    def fer(self) -> float:
        return self.frame_errors / self.trials if self.trials else 0.0

    def csv(self) -> str:
        # schema-compatible with perftest/src/main.rs:62
        return f"{self.code},{self.snr_db},{self.trials},{self.bits},{self.bit_errors},{self.ber:.6e}"


class _Checkpoint:
    """Append-only JSONL persistence of partial waterfall counts.

    One line per drained batch: the current point's counters plus the
    number of batches drained so far in the sweep. On resume the sweep
    continues at that batch index, so the continued trial stream is the
    suffix of the uninterrupted one (batches in flight but never drained are
    re-run). A config header line guards against resuming with other
    parameters, and its "rng" key (absent from the JAX package's
    checkpoints) against resuming onto another random stream.

    With a mesh, rank 0 alone opens, reads, checks and appends the file (the
    other ranks never touch it, so it need not be visible to them), and
    sends every rank what it read, or the error that reading raised, by one
    `broadcast_object`: a mismatch raises on every rank, and every rank
    resumes at the same batch. The counters it writes are already global
    (`awgn.TrialStep` sums them over the ranks), so a write needs no
    collective. The world size is not in the config: every rank draws the
    whole global batch and keeps its rows, so the counters do not depend on
    the ranks, and a file written by one mesh resumes on any other. A write
    that fails on rank 0 mid-sweep (a full disk, a lost mount) raises on
    rank 0 alone; the other ranks then wait in the next batch's `all_reduce`
    until the process group's timeout ends the job, and the lines written
    before it resume as usual.
    """

    def __init__(self, path, config: dict, mesh: BatchMesh | None = None):
        self.path = Path(path)
        self._f = None
        state = None
        if mesh is None or mesh.rank == 0:
            # a failure to read is sent like a result and raised on every rank
            # after the broadcast: raised on rank 0 alone, it would leave the
            # other ranks waiting in their next collective
            try:
                state = self._open(config)
            except Exception as e:
                state = e
        if mesh is not None:
            state = broadcast_object(mesh, state)
        if isinstance(state, Exception):
            raise state
        self.points, self.batches = state

    def _open(self, config: dict) -> tuple[dict[float, dict], int]:
        """Read and check an existing file, or start one with the config
        line; leave it open for appending. Returns (point records by snr,
        batches drained)."""
        points: dict[float, dict] = {}
        batches = 0
        if not self.path.exists():
            self._f = self.path.open("w")
            self._write({"kind": "config", **config})
            return points, batches
        with self.path.open() as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec.get("kind") == "config":
                    mismatched = {
                        k: (v, rec.get(k)) for k, v in config.items() if rec.get(k) != v
                    }
                    if mismatched:
                        raise ValueError(
                            f"checkpoint {self.path} was written with different "
                            f"parameters: {mismatched}"
                        )
                elif rec.get("kind") == "point":
                    points[float(rec["snr_db"])] = rec
                    batches = max(batches, int(rec["batches"]))
        self._f = self.path.open("a")
        return points, batches

    def _write(self, rec: dict):
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def lookup(self, snr_db: float) -> tuple[SnrPoint | None, bool]:
        """(restored point or None, whether it already completed)."""
        rec = self.points.get(float(snr_db))
        if rec is None:
            return None, False
        pt = SnrPoint(**{k: rec[k] for k in SnrPoint.__dataclass_fields__ if k in rec})
        return pt, bool(rec.get("done"))

    def record(self, pt: SnrPoint, batches: int, done: bool):
        """Append the point's counters (rank 0's file; a no-op on the others)."""
        if self._f is not None:
            self._write({"kind": "point", **asdict(pt), "batches": batches, "done": done})

    def close(self):
        if self._f is not None:
            self._f.close()


def _batch_generator(seed: int, index: int, device: torch.device) -> torch.Generator:
    """The generator of batch `index` of a sweep, seeded by (seed, index)."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _make_step(code, batch, maxiters, noise_model, dtype_name, alpha, impl, llr_scale,
               decoder, dev, mesh):
    """The trial step of a decode surface; refuses noise models the surface
    does not take and arguments it would ignore."""
    if decoder not in _NOISE_MODELS:
        raise ValueError(f"unknown decoder {decoder!r} (ms|ms_hard|bf)")
    if noise_model not in _NOISE_MODELS[decoder]:
        raise ValueError(
            f"decoder {decoder!r} takes noise_model {'|'.join(_NOISE_MODELS[decoder])}, "
            f"not {noise_model!r}"
        )
    if decoder == "ms":
        return make_trial_step(code, batch, maxiters, dtype_name, alpha, impl, llr_scale, dev,
                               mesh)
    if dtype_name != "float32" or alpha is not None or llr_scale is not None:
        raise ValueError(
            f"decoder {decoder!r} takes hard bits: dtype_name, alpha and llr_scale apply to "
            "decoder='ms' only"
        )
    from .hard import make_bf_trial_step, make_ms_hard_trial_step

    make = make_bf_trial_step if decoder == "bf" else make_ms_hard_trial_step
    return make(code, batch, maxiters, noise_model, impl, dev, mesh)


@spanned("ldpc.waterfall")
def waterfall(
    code: LDPCCode | str,
    snrs_db: list[float],
    batch: int = 1024,
    maxiters: int = 100,
    max_bits: int = 50_000_000,  # perftest/src/main.rs:50
    max_bit_errors: int = 5_000,  # perftest/src/main.rs:50
    noise_model: str = "perftest",
    dtype_name: str = "float32",
    alpha: float | None = None,
    impl: str = "auto",
    llr_scale: float | None = None,
    seed: int = 0,
    csv_out=None,
    verbose: bool = False,
    pipeline_depth: int = 4,
    checkpoint=None,
    decoder: str = "ms",
    device="cuda",
    mesh: BatchMesh | None = None,
) -> list[SnrPoint]:
    """Run a BER/FER waterfall sweep on `device`; returns one SnrPoint per SNR.

    Stopping rules per point mirror the reference: stop when `max_bits` data
    bits have been simulated or `max_bit_errors` bit errors observed.

    `decoder` selects the decode surface: "ms" (soft channel, AWGN on the
    LLRs per `noise_model` "perftest"/"ebn0"), "ms_hard" (min-sum on
    hard-sliced channel output) or "bf" (hard-decision bit-flip). With
    noise_model "bsc"/"bec" the `snrs_db` values are flip/erasure
    probabilities. "ms" takes impl auto|ref|qc|qc_i8|qc_i16|layered|
    cuda_layered|cuda_qc and `dtype_name` float32|bfloat16|float64|int8|
    int16|int32 (int8 and int16 quantized with `llr_scale`, default
    `default_llr_scale`; float64 not on the cuda_* impls), and the
    sum-product impls sp|sp_layered|cuda_sp on float32 true LLRs 2y/sigma^2
    (as the JAX package, sum-product is a decoder="ms" impl); "ms_hard" the
    min-sum impls; "bf" auto|cuda|qc|gather. "auto" is a CUDA kernel on a
    CUDA device (the plain layered decoder for float64, the reference-order
    decoder for int32).

    Up to `pipeline_depth` trial steps are kept in flight (CUDA launches are
    asynchronous), so the card is not idle between batches. As in the
    reference perftest, batches already in flight when the bit-error budget
    trips are still counted (deterministic for a fixed seed and depth); the
    bits budget is computed ahead of launch and never overshoots.

    With `checkpoint` (a file path), partial counts are persisted after
    every drained batch; rerunning the same sweep resumes mid-point and
    gives the counters of an uninterrupted run (see _Checkpoint). If the
    interruption raced the bit-error budget tripping, the resumed run may
    count up to pipeline_depth fewer in-flight batches; both are valid
    stopping outcomes under the reference protocol.

    With `mesh`, `batch` is the global batch, split over the mesh's ranks
    (it must divide by them), and the sweep runs on the mesh's device, which
    must be of `device`'s type; every rank returns the same points and only
    rank 0 prints. Every rank passes the same `checkpoint` path, and rank 0
    alone reads and writes it (the JAX package's launcher has every process
    append to it, labrador_ldpc_tpu/parallel/launch.py:79-86); a file written
    on any number of ranks resumes on any other number.

    Traced (`utils.tracing`): `ldpc.waterfall` around the call, and inside it
    `ldpc.waterfall.setup`, one `ldpc.waterfall.point` a point, and in a
    point one `ldpc.trial_step` a batch enqueued and one
    `ldpc.waterfall.drain` a batch read back.
    """
    code = get_code(code)
    dev = resolve_device(device)
    k = code.k
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    if mesh is not None and mesh.rank != 0:
        csv_out, verbose = None, False
    with span("ldpc.waterfall.setup"):
        # the checkpoint config records the resolved impl: a checkpoint written
        # with the kernel must not resume onto another decoder
        step = _make_step(code, batch, maxiters, noise_model, dtype_name, alpha, impl, llr_scale,
                          decoder, dev, mesh)
        dev = step.device
        ckpt = None
        next_batch = 0
        if checkpoint is not None:
            ckpt = _Checkpoint(
                checkpoint,
                {
                    "code": code.value,
                    "batch": batch,
                    "maxiters": maxiters,
                    "max_bits": max_bits,
                    "max_bit_errors": max_bit_errors,
                    "noise_model": noise_model,
                    "dtype_name": dtype_name,
                    "alpha": alpha,
                    "impl": step.impl,
                    "llr_scale": llr_scale,
                    "seed": seed,
                    "decoder": decoder,
                    "rng": f"torch-{dev.type}",
                },
                mesh,
            )
            next_batch = ckpt.batches
    drained = next_batch
    results = []
    # each step simulates exactly batch*k data bits, so the bits budget
    # translates to a step count ahead of time
    n_steps_max = max(1, -(-max_bits // (batch * k)))
    for snr in snrs_db:
        with span("ldpc.waterfall.point", "snr", snr):
            param = snr if noise_model in ("bsc", "bec") else noise_sigma(snr, code, noise_model)
            pt = SnrPoint(code=code.value, snr_db=snr)
            launched = 0
            elapsed0 = 0.0
            if ckpt is not None:
                restored, done = ckpt.lookup(snr)
                if restored is not None:
                    pt = restored
                    if done:
                        results.append(pt)
                        if csv_out is not None:
                            print(pt.csv(), file=csv_out, flush=True)
                        continue
                    launched = pt.trials // batch  # each step counts exactly batch
                    elapsed0 = pt.elapsed_s
            t0 = time.perf_counter()
            inflight: list = []
            while True:
                while (
                    launched < n_steps_max
                    and len(inflight) < max(1, pipeline_depth)
                    and pt.bit_errors < max_bit_errors
                ):
                    inflight.append(step(_batch_generator(seed, next_batch, dev), param,
                                         next_batch))
                    next_batch += 1
                    launched += 1
                if not inflight:
                    break
                with span("ldpc.waterfall.drain"):
                    trials, bit_errors, frame_errors, failures, iters = \
                        torch.stack(list(inflight.pop(0))).tolist()
                pt.trials += trials
                pt.bits += trials * k
                pt.bit_errors += bit_errors
                pt.frame_errors += frame_errors
                pt.decode_failures += failures
                pt.iterations += iters
                drained += 1
                if ckpt is not None:
                    pt.elapsed_s = elapsed0 + time.perf_counter() - t0
                    ckpt.record(pt, drained, done=False)
            pt.elapsed_s = elapsed0 + time.perf_counter() - t0
            if ckpt is not None:
                ckpt.record(pt, drained, done=True)
            results.append(pt)
            line = pt.csv()
            if csv_out is not None:
                print(line, file=csv_out, flush=True)
            if verbose:
                print(
                    f"{line}  fer={pt.fer:.3e} cw/s={pt.trials / max(pt.elapsed_s, 1e-9):,.0f}",
                    file=sys.stderr,
                    flush=True,
                )
    if ckpt is not None:
        ckpt.close()
    return results
