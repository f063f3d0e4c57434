"""Device milliseconds a training step of GroupNorm's backward kernels,
B1 (``group_norm_bwd_reduce_kernel``) and B2
(``group_norm_bwd_apply_kernel``), over the window's steps: the part of
``backward_ms.train`` that the UNet's GroupNorm gradients take (their
statistics run in K1's moments entry, named as K1).  None where no such
kernel ran."""

KERNELS = ("group_norm_bwd_reduce_kernel", "group_norm_bwd_apply_kernel")


def read(w):
    t = w.trace.kernel_s(KERNELS)
    return 1e3 * t / w.units if t > 0 else None
