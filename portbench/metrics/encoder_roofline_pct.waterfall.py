"""Share of its roofline that the encoder (`ops/encoder.encode_bits`)
reaches in a waterfall cell: the GF(2) product's bound for every codeword
of the window (`roofline.encoder`) over the device time of the operations
inside the `portbench.encode_bits` ranges, which the traced run opens
around the call of `encode_bits` in `channel/awgn.py`. None where the trace
holds no such range."""

from portbench import roofline

RANGE = "portbench.encode_bits"


def read(trace, counts, config):
    measured = trace.time_in_ranges_s(RANGE)
    if measured is None:
        return None
    bound, _ = roofline.encoder(config["k"], config["n"], counts["trials"])
    return roofline.share_pct(bound, measured)
