"""Roofline share of the UNet21's attention backward (K5 dQ, K4 dK/dV):
10·T·S·d flops a head and the tensors read and written once
(work/counter.py's ``attn_bwd``) over the device time of the kernels
named here."""

KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def read(w):
    t, op = w.trace.kernel_s(KERNELS), w.work.ops.get("attn_bwd")
    return 100.0 * op[2] * w.units / t if t > 0 and op else None
