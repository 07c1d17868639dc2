"""Share of the traced window of a waterfall cell in which no kernel runs on
the card; a copy alone counts as idle, so an exposed copy shows here."""

from portbench.trace import union_us


def read(trace, counts, config):
    span = trace.window[1] - trace.window[0]
    return 100.0 * (1 - union_us(trace.kernels, trace.window) / span)
