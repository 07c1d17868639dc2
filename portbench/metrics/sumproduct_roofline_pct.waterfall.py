"""Share of its roofline that the row-layered sum-product kernel
(`csrc/sumproduct.cu`, launched by `ops/cuda_sp.py`) reaches in a waterfall
cell: the algorithm's bound for the trials and sweeps of the window's calls
(`roofline_sp.sumproduct`) over the kernel's device time in the trace. None
where no sum-product kernel ran."""

from portbench import roofline, roofline_sp

KERNEL = "sumproduct_kernel"  # the kernel's name in csrc/sumproduct.cu


def read(trace, counts, config):
    bound, _ = roofline_sp.sumproduct(config["edges"], config["n"], config["n_vars"],
                                      counts["trials"], counts["sweeps"])
    return roofline.share_pct(bound, trace.kernel_time_s(KERNEL))
