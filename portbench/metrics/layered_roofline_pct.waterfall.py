"""Share of its roofline that the layered min-sum kernel
(`csrc/layered_minsum.cu`) reaches in a waterfall cell: the algorithm's
bound for the trials and sweeps of the window's calls (`roofline.layered`)
over the kernel's device time in the trace. None where no layered kernel
ran (a bit-flip sweep)."""

from portbench import roofline

KERNEL = "layered_minsum_kernel"  # the kernel's name in csrc/layered_minsum.cu


def read(trace, counts, config):
    bound, _ = roofline.layered(config["edges"], config["n"], config["n_vars"], counts["trials"],
                                counts["sweeps"], counts["dtype"])
    return roofline.share_pct(bound, trace.kernel_time_s(KERNEL))
