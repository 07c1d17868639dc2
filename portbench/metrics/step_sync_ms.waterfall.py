"""Host time a batch that a waterfall cell's trial step waits for the card:
per `ldpc.trial_step` span (one batch enqueued by `channel/waterfall`), the
time inside synchronising CUDA runtime calls (`portbench.spans.SYNC_CALLS`),
as a mean over the window's steps. Near a batch's device time where the
step waits for its own decode; near 0 where it only enqueues. None where
the program opens no such span."""

from portbench.spans import mean_ms, spans, sync_us

SPAN = "ldpc.trial_step"


def read(trace, counts, config):
    return mean_ms(sync_us(trace, spans(trace, SPAN)))
