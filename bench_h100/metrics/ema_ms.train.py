"""Device milliseconds a training step of the parameters' EMA: the ops
launched inside the program's span ``train.ema``, over the window's
steps."""

SPANS = ("train.ema",)


def read(w):
    s = w.trace.span_device_s(SPANS)
    return 1e3 * s / w.units if s > 0 else None
