"""Pipelined slope timing: seconds per dispatch of work kept in flight.

PyTorch counterpart of `labrador_ldpc_tpu/utils/timing.py`. Trains of
{k/4, k/2, 3k/4, k} back-to-back dispatches, best of `reps` each, then the
least-squares slope of train time against dispatch count: a constant cost
per train (the final synchronisation, a host round trip) cancels in the fit
instead of being spread over the answer, so the number is the sustained
marginal time of one dispatch. The wall clock is `time.perf_counter`, not
CUDA events: the slope is over launches in flight, and events would not see
the host's gaps between them.

`sync(out)` must wait for the last dispatch's work: on the card
`torch.cuda.synchronize()`, or a copy of part of the output to the host
(kernels on one stream run in launch order, so the copy cannot finish
early).
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["pipelined_slope"]


def pipelined_slope(fn, arg, sync, k: int = 32, reps: int = 3, clock=time.perf_counter) -> float:
    """Seconds per dispatch of `fn(arg)` (see the module docstring). `fn`
    must enqueue its work and return without waiting for it; `clock` is the
    wall clock (a parameter so that a test can fake it)."""

    def train(count):
        best = float("inf")
        for _ in range(reps):
            t0 = clock()
            outs = [fn(arg) for _ in range(count)]
            sync(outs[-1])
            best = min(best, clock() - t0)
            del outs
        return best

    ks = sorted({max(1, k * i // 4) for i in (1, 2, 3, 4)})
    ts = [train(c) for c in ks]
    xs, ys = np.asarray(ks, np.float64), np.asarray(ts, np.float64)
    denom = float(((xs - xs.mean()) ** 2).sum())
    return float(((xs - xs.mean()) * (ys - ys.mean())).sum() / max(denom, 1e-12))
