"""Share of the traced window of rank 0's card in which NCCL kernels run and
no other kernel does, in %: the card held at a batch's `all_reduce` (and at
a sweep's decision) until the slowest rank arrives, the next batch's
kernels queued behind it on the stream. None where the program opens no
`ldpc.all_reduce` span, as a program without the spans does."""

from portbench.spans import spans
from portbench.trace import union_us

SPAN = "ldpc.all_reduce"


def read(trace, counts, config):
    if not spans(trace, SPAN):
        return None
    others = [k for k in trace.kernels if "nccl" not in k[0].lower()]
    alone = union_us(trace.kernels, trace.window) - union_us(others, trace.window)
    return 100.0 * alone / (trace.window[1] - trace.window[0])
