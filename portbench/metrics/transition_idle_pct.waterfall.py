"""Device idle at a waterfall cell's point and call changes: the
kernel-free gaps of the window (`trace.gaps_us` over the kernels) that hold
the end of an `ldpc.waterfall.point` span, each gap once, summed over the
window's length, in %. None where the program opens no such span."""

import bisect

from portbench.spans import spans
from portbench.trace import gaps_us

SPAN = "ldpc.waterfall.point"


def read(trace, counts, config):
    ends = sorted(e for _, e in spans(trace, SPAN))
    if not ends:
        return None
    idle = 0.0
    for g0, g1 in gaps_us(trace.kernels, trace.window):
        i = bisect.bisect_left(ends, g0)
        if i < len(ends) and ends[i] <= g1:
            idle += g1 - g0
    return 100.0 * idle / (trace.window[1] - trace.window[0])
