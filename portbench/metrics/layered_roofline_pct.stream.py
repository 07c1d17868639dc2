"""Share of its roofline that the layered min-sum kernel
(`csrc/layered_minsum.cu`, launched by `ops/cuda_layered.py`) reaches in a
stream cell: the algorithm's bound for the frames and sweeps of the window
(`roofline.layered`) over the kernel's device time in the trace."""

from portbench import roofline

KERNEL = "layered_minsum_kernel"  # the kernel's name in csrc/layered_minsum.cu


def read(trace, counts, config):
    bound, _ = roofline.layered(config["edges"], config["n"], config["n_vars"], counts["frames"],
                                counts["sweeps"], counts["dtype"])
    return roofline.share_pct(bound, trace.kernel_time_s(KERNEL))
