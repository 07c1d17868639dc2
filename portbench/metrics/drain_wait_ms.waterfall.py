"""Host time a batch that a waterfall cell spends reading a batch's counters
back: the mean duration of the window's `ldpc.waterfall.drain` spans
(`torch.stack(...).tolist()`, which waits for the batch's work). None where
the program opens no such span."""

from portbench.spans import mean_ms, spans

SPAN = "ldpc.waterfall.drain"


def read(trace, counts, config):
    return mean_ms([e - s for s, e in spans(trace, SPAN)])
