"""Device milliseconds a training step of the microbatches' forward (q_sample,
the UNet, the hybrid loss): the ops launched inside the program's span
``train.forward``, over the window's steps."""

SPANS = ("train.forward",)


def read(w):
    s = w.trace.span_device_s(SPANS)
    return 1e3 * s / w.units if s > 0 else None
