"""Sustained decode serving: batches kept in flight, every frame verified.

PyTorch counterpart of `examples/serve_decode.py`. Kernel launches are
asynchronous, so a server enqueues batches back to back and consumes each
result as it drains, never waiting between launches; waiting on every
batch would measure the host's round trip, not the decoder. This decodes a
stream of TM8192 codewords with 3 flipped bits in byte 0 (the `bench.py`
scenario) through `decode_ms(impl="auto")` (the layered CUDA kernel) with
DEPTH batches in flight. Each batch's success flags and packed data bytes
(k/8 a frame) are copied to pinned host buffers without blocking, read once
a CUDA event says the copy is done, and checked: every frame must have
converged and carry the bytes that were sent. Then
`utils.timing.pipelined_slope` measures the time of one decode dispatch.

    python -m labrador_ldpc_tpu_torch.serve [n_batches]
"""

from __future__ import annotations

import sys
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from .codes.params import LDPCCode, get_code
from .device import resolve_device
from .ops.convert import hard_to_llrs, pack_bits
from .ops.encoder import encode
from .ops.minsum import decode_ms
from .utils.timing import pipelined_slope

__all__ = ["ServeReport", "serve", "flipped_codewords", "FLIPS"]

FLIPS = (1 << 7) | (1 << 5) | (1 << 3)  # the bits flipped in byte 0 of every frame
DEPTH = 4  # batches in flight: bounds the device queue and the pinned host buffers
MAXITERS = 50
SLOPE_REPS = 3


def flipped_codewords(code: LDPCCode | str, batch: int, device="cuda"):
    """The `bench.py` scenario's frames: (data bytes (batch, k/8) drawn from
    `np.random.default_rng(0)`, on the CPU; their codewords (batch, n/8) on
    `device` with the bits of FLIPS flipped in byte 0)."""
    code = get_code(code)
    dev = resolve_device(device)
    sent = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (batch, code.k // 8), dtype=np.uint8))
    cw = encode(code, sent.to(dev), dev)
    cw[:, 0] ^= FLIPS
    return sent, cw


@dataclass(frozen=True)
class ServeReport:
    code: str
    batch: int
    batches: int
    frames: int  # frames decoded and checked
    seconds: float  # wall time of the stream, host clock
    failures: int  # frames that did not converge
    wrong: int  # frames whose data bytes differ from those sent
    dispatch_s: float  # seconds a decode dispatch, `pipelined_slope`
    dispatches: int  # decode dispatches in all: warm-up, stream and slope

    @property
    def frames_per_s(self) -> float:
        return self.frames / self.seconds


def serve(n_batches: int = 32, code: LDPCCode | str = "TM8192", batch: int = 16384,
          slope_k: int = 32, device="cuda") -> ServeReport:
    """Decode `n_batches` batches of `batch` corrupted frames with DEPTH
    in flight, check every frame, then time one dispatch over trains of up to
    `slope_k` dispatches. On the CPU the copies are plain and synchronous;
    the numbers are the CPU's."""
    code = get_code(code)
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    sent, cw = flipped_codewords(code, batch, dev)
    llrs = hard_to_llrs(cw, torch.float32, dev)

    def dispatch(x):
        res = decode_ms(code, x, maxiters=MAXITERS, impl="auto", device=dev)
        return res.success, pack_bits(res.bits[:, : code.k], dev)

    dispatch(llrs[:8])  # build the decoder (and load the kernel) once
    if cuda:
        torch.cuda.synchronize(dev)
    # one pair of host buffers a batch in flight: a slot is reused only after
    # its batch was drained
    slots = [(torch.empty((batch,), dtype=torch.bool, pin_memory=cuda),
              torch.empty((batch, code.k // 8), dtype=torch.uint8, pin_memory=cuda))
             for _ in range(DEPTH)]
    inflight: deque = deque()
    failures = wrong = 0

    def drain():
        nonlocal failures, wrong
        ok, data, done = inflight.popleft()
        if done is not None:
            done.synchronize()
        failures += int((~ok).sum())
        if not torch.equal(data, sent):
            wrong += int((data != sent).any(dim=1).sum())

    t0 = time.perf_counter()
    for i in range(n_batches):
        success, data_bytes = dispatch(llrs)
        ok, data = slots[i % DEPTH]
        ok.copy_(success, non_blocking=cuda)
        data.copy_(data_bytes, non_blocking=cuda)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()
        inflight.append((ok, data, done))
        if len(inflight) >= DEPTH:
            drain()
    while inflight:
        drain()
    seconds = time.perf_counter() - t0

    def sync(out):
        out[0][:1].cpu()  # the last dispatch's first flag: launches run in order

    dispatch_s = pipelined_slope(dispatch, llrs, sync, k=slope_k, reps=SLOPE_REPS)
    slope = SLOPE_REPS * sum({max(1, slope_k * i // 4) for i in (1, 2, 3, 4)})
    return ServeReport(code.value, batch, n_batches, n_batches * batch, seconds, failures, wrong,
                       dispatch_s, 1 + n_batches + slope)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_batches = int(argv[0]) if argv else 32
    r = serve(n_batches)
    print(f"{r.frames} frames of {r.code} in {r.seconds:.3f} s -> {r.frames_per_s:,.0f} frames/s "
          f"sustained on {torch.cuda.get_device_name(0)}; {r.failures} failed to converge, "
          f"{r.wrong} with wrong data; {r.dispatch_s * 1e3:.4f} ms a decode dispatch "
          f"(pipelined slope)")
    return 0 if r.failures == 0 and r.wrong == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
