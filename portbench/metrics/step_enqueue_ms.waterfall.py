"""Host time it costs a waterfall cell to enqueue one batch: the mean
duration of the window's `ldpc.trial_step` spans less the time inside
their synchronising CUDA runtime calls (`portbench.spans.SYNC_CALLS`).
None where the program opens no such span."""

from portbench.spans import mean_ms, spans, sync_us

SPAN = "ldpc.trial_step"


def read(trace, counts, config):
    steps = spans(trace, SPAN)
    return mean_ms([e - s - w for (s, e), w in zip(steps, sync_us(trace, steps))])
