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

`pipelined_fit` returns the whole fit (its points, slope, intercept, R^2
and the amortized rate of the longest train); `pipelined_slope` is its slope.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

__all__ = ["Fit", "pipelined_fit", "pipelined_slope"]

# a rate from the slope may exceed the longest train's amortized rate by the
# amortized constant only; past this factor the fit is taken as degenerate
RATE_CAP = 1.5


@dataclass(frozen=True)
class Fit:
    points: tuple[tuple[int, float], ...]  # (dispatches in a train, best seconds of the train)
    slope: float  # seconds a dispatch
    intercept: float  # seconds a train costs beyond its dispatches
    r2: float  # coefficient of determination of the line through the points
    amortized: float  # dispatches a second over the longest train, constant included

    @property
    def residuals(self) -> tuple[float, ...]:
        return tuple(t - (self.slope * k + self.intercept) for k, t in self.points)

    def rate(self, work: float) -> float:
        """`work` a dispatch over the slope's seconds a dispatch, never more
        than RATE_CAP times the longest train's amortized rate (a guard
        against a degenerate fit of noisy short trains)."""
        return min(work / max(self.slope, 1e-9), RATE_CAP * work * self.amortized)


def pipelined_fit(fn, arg, sync, k: int = 32, reps: int = 3, clock=time.perf_counter) -> Fit:
    """The fit of train time against dispatches of `fn(arg)` (see the module
    docstring). `fn` must enqueue its work and return without waiting for
    it; `clock` is the wall clock (a parameter so that a test can fake it)."""

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
    slope = float(((xs - xs.mean()) * (ys - ys.mean())).sum() / max(denom, 1e-12))
    intercept = float(ys.mean() - slope * xs.mean())
    ss_res = float(((ys - (slope * xs + intercept)) ** 2).sum())
    ss_tot = float(((ys - ys.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / max(ss_tot, 1e-30)
    return Fit(tuple(zip(ks, ts)), slope, intercept, r2, ks[-1] / max(ts[-1], 1e-12))


def pipelined_slope(fn, arg, sync, k: int = 32, reps: int = 3, clock=time.perf_counter) -> float:
    """Seconds per dispatch of `fn(arg)`: the slope of `pipelined_fit`."""
    return pipelined_fit(fn, arg, sync, k, reps, clock).slope
