"""Roofline share of the spatial attention the flash forward kernel (K3)
serves in the UNet22 and the MoVQ decoder: the least time its work could
take on the card (work/counter.py's ``attn``, from the configuration's
shapes, times the window's calls) over the device time of the kernels
named here."""

KERNELS = ("flash_fwd_d64_kernel", "flash_fwd_d512_kernel")


def read(w):
    t, op = w.trace.kernel_s(KERNELS), w.work.ops.get("attn")
    return 100.0 * op[2] * w.units / t if t > 0 and op else None
