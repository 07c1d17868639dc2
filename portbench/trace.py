"""The traced run's device timeline, from `torch.profiler`.

`profiled()` wraps the measured window in `torch.profiler.profile` (CPU and
CUDA activity) and a `record_function` range named WINDOW; it yields a
holder whose `.trace` is filled when the block ends. `Trace` keeps the
window and four lists of `(name, start_us, end_us)`: kernels, copies and
sets (`Memcpy*`/`Memset*`), device-side user ranges (the profiler mirrors a
`record_function` range onto the device timeline, from its first to its
last operation), and host operations. Every reader works on these lists,
so the tests reach them without a card.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from dataclasses import dataclass, field

__all__ = ["WINDOW", "Trace", "profiled", "union_us", "gaps_us"]

WINDOW = "portbench.window"


@dataclass
class Trace:
    window: tuple[float, float]  # µs, the profiler's clock
    kernels: list = field(default_factory=list)
    copies: list = field(default_factory=list)
    ranges: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def ops(self) -> list:
        """Every device operation: kernels, copies and sets."""
        return self.kernels + self.copies

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return union_us(self.ops(), self.window) / 1e6

    def kernel_time_s(self, kernel: str) -> float:
        """Summed device time of the kernels named `kernel` in their source,
        whatever their namespace, template arguments and parameters (the
        profiler names `void (anonymous namespace)::layered_minsum_kernel<float, 2>(...)`)."""
        pattern = re.compile(rf"(?:^|[\s:]){re.escape(kernel)}(?:[<(]|$)")
        return sum(e - s for name, s, e in self.kernels if pattern.search(name)) / 1e6

    def time_in_ranges_s(self, range_name: str) -> float | None:
        """Device time of the operations inside the device-side ranges named
        `range_name`; None where there is no such range."""
        spans = sorted((s, e) for name, s, e in self.ranges if name == range_name)
        if not spans:
            return None
        starts = [s for s, _ in spans]
        total = 0.0
        for _, s, e in self.ops():
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= spans[i][1]:
                total += e - s
        return total / 1e6

    def top_ops(self, n: int = 10) -> list:
        """The `n` device operations that took most time, names cut to 160
        characters."""
        totals: dict[str, float] = {}
        for name, s, e in self.ops():
            totals[name[:160]] = totals.get(name[:160], 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:n]

    def idle_by_host(self, n: int = 10, label_gaps: int = 500) -> list:
        """Device idle time (no kernel, copy or set running) grouped by the
        innermost host operation running at the middle of each gap, over the
        `label_gaps` longest gaps; the `n` largest groups."""
        gaps = sorted(gaps_us(self.ops(), self.window), key=lambda g: -(g[1] - g[0]))
        host = sorted((s, e, name) for name, s, e in self.host if name != WINDOW)
        starts = [h[0] for h in host]
        totals: dict[str, float] = {}
        for g0, g1 in gaps[:label_gaps]:
            mid = (g0 + g1) / 2
            best = None
            i = bisect.bisect_right(starts, mid) - 1
            # the innermost operation started shortly before: look back 4096 at most
            for s, e, name in (host[j] for j in range(i, max(i - 4096, -1), -1)):
                if e >= mid and (best is None or e - s < best[1] - best[0]):
                    best = (s, e, name)
            label = best[2] if best else "(python, in no profiled operation)"
            totals[label] = totals.get(label, 0.0) + (g1 - g0) / 1e6
        return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:n]


def _merged(events, window) -> list:
    w0, w1 = window
    spans = sorted((max(s, w0), min(e, w1)) for _, s, e in events)
    out: list = []
    for s, e in spans:
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_us(events, window) -> float:
    """Length of the union of the events' intervals inside the window."""
    return sum(e - s for s, e in _merged(events, window))


def gaps_us(events, window) -> list:
    """The stretches of the window that no event covers, as (start, end)."""
    out, cursor = [], window[0]
    for s, e in _merged(events, window):
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if window[1] > cursor:
        out.append((cursor, window[1]))
    return out


class _Holder:
    trace: Trace | None = None


@contextlib.contextmanager
def profiled(device):
    """Profile the block; `holder.trace` is set when it ends."""
    import torch

    holder = _Holder()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        # the profiler's first launch sets up its buffers: keep it out of the window
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)
        with torch.profiler.record_function(WINDOW):
            yield holder
        torch.cuda.synchronize(device)
    holder.trace = from_events(prof.events())


def from_events(events) -> Trace:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    window = None
    kernels, copies, ranges, host = [], [], [], []
    for e in events:
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == cuda:
            if e.is_user_annotation or e.name.startswith("ProfilerStep"):
                ranges.append(rec)
            elif e.name.startswith(("Memcpy", "Memset")):
                copies.append(rec)
            else:
                kernels.append(rec)
        elif e.name == WINDOW:
            window = rec[1:]
        else:
            host.append(rec)
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW!r} range")
    if not kernels:
        raise RuntimeError("torch.profiler recorded no kernel on the card in the window")
    return Trace(window, kernels, copies, ranges, host)
