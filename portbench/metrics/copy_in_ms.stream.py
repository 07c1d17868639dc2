"""Device time of the host-to-device copies a batch in a stream cell: the
copies of the host batch that `ops/minsum.decode_ms` makes, from the
trace's `Memcpy HtoD` operations, over the batches of the window."""

PREFIX = "Memcpy HtoD"


def read(trace, counts, config):
    if not counts["batches"]:
        return None
    total = sum(e - s for name, s, e in trace.copies if name.startswith(PREFIX))
    return total / 1e3 / counts["batches"]
