"""The program's host spans in a traced window, for the per-layer metrics of
the entry points.

The port opens named host ranges (`labrador_ldpc_tpu_torch.utils.tracing`)
while a `torch.profiler` records: `ldpc.decode_ms` with `ldpc.copy_in` and
`ldpc.decode` inside; `ldpc.waterfall` with `ldpc.waterfall.setup`, one
`ldpc.waterfall.point` a point, and inside a point an `ldpc.trial_step` a
batch enqueued (`ldpc.draw`, `ldpc.encode`, `ldpc.channel`, `ldpc.decode`,
`ldpc.count`) and an `ldpc.waterfall.drain` a batch read back. They are in
`Trace.host` with the profiler's host operations and CUDA runtime calls, on
the clock of the device's kernels.

A span counts where it lies wholly inside the window; one cut by the
window's start or end is left out, so a mean is over whole spans only.

SYNC_CALLS are the CUDA runtime calls in which the host waits for the
device: `cudaStreamSynchronize` (which PyTorch issues after a copy with
`non_blocking=False`, and `.item()`/`.tolist()` after theirs),
`cudaEventSynchronize`, `cudaDeviceSynchronize`, and the blocking
`cudaMemcpy` (not `cudaMemcpyAsync`). On the H100's trace (PyTorch 2.11)
every wait inside the spans is a `cudaStreamSynchronize`: after the blocking
copy of `ldpc.copy_in`, of the AWGN channel's sigma (`ldpc.channel`), of
the trials counter (`ldpc.count`) and of `.tolist()` (`ldpc.waterfall.drain`);
the other three are kept for the program's other waits (`Event.synchronize`,
`torch.cuda.synchronize`). A reader returns None where the trace holds none
of the spans it reads, as a trace of a program without them does.
"""

from __future__ import annotations

import bisect

from portbench.trace import union_us

__all__ = ["SYNC_CALLS", "spans", "inside", "sync_us", "mean_ms"]

SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy")


def spans(trace, names) -> list:
    """The host events of a name in `names` (one name, or several) that lie
    wholly inside the window, as (start_us, end_us), sorted."""
    names = (names,) if isinstance(names, str) else tuple(names)
    w0, w1 = trace.window
    return sorted((s, e) for name, s, e in trace.host if name in names and w0 <= s and e <= w1)


def inside(events: list, span: tuple) -> list:
    """The events of the sorted list `events` that lie within `span`."""
    s0, e0 = span
    i = bisect.bisect_left(events, (s0,))
    out = []
    while i < len(events) and events[i][0] <= e0:
        if events[i][1] <= e0:
            out.append(events[i])
        i += 1
    return out


def sync_us(trace, within: list) -> list:
    """Host µs inside synchronising runtime calls, for each span of `within`
    (overlapping calls counted once)."""
    calls = spans(trace, SYNC_CALLS)
    return [union_us([(None, s, e) for s, e in inside(calls, w)], w) for w in within]


def mean_ms(durations_us: list) -> float | None:
    return sum(durations_us) / len(durations_us) / 1e3 if durations_us else None

