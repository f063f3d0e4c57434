"""Roofline share of the GroupNorms (K1 statistics + K2 apply) of the
UNet22 and the MoVQ decoder: each norm's input read once and output
written once at the HBM bandwidth (work/counter.py's ``gn``), over the
device time of the kernels named here."""

KERNELS = ("group_norm_stats_kernel", "group_norm_apply_kernel")


def read(w):
    t, op = w.trace.kernel_s(KERNELS), w.work.ops.get("gn")
    return 100.0 * op[2] * w.units / t if t > 0 and op else None
