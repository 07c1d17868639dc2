"""Share of its roofline that the bit-flip kernel (`csrc/bitflip.cu`,
launched by `ops/cuda_bf.py`) reaches in a waterfall cell: the algorithm's
bound (`roofline.bitflip`) for the trials and iterations of the window's
calls, with the erasure pass of a punctured code counted as one iteration
more a codeword, over the kernel's device time in the trace."""

from portbench import roofline

KERNEL = "bitflip_kernel"  # the kernel's name in csrc/bitflip.cu


def read(trace, counts, config):
    iterations = counts["sweeps"] + (counts["trials"] if config["punctured_bits"] else 0)
    bound, _ = roofline.bitflip(config["edges"], config["n"], config["n_vars"], counts["trials"],
                                iterations)
    return roofline.share_pct(bound, trace.kernel_time_s(KERNEL))
