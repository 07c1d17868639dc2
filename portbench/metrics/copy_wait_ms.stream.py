"""Host time a batch that a stream cell's `ops/minsum.decode_ms` spends
moving the host batch to the card: the mean duration of the window's
`ldpc.copy_in` spans, the blocking `torch.as_tensor(llrs, device=dev)`
(with its wait for the stream's earlier work). None where the program opens
no such span."""

from portbench.spans import mean_ms, spans

SPAN = "ldpc.copy_in"


def read(trace, counts, config):
    return mean_ms([e - s for s, e in spans(trace, SPAN)])
