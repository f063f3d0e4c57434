"""Device milliseconds a training step of the microbatches' backward (with
``remat`` the recomputed forward too): the ops launched inside the
program's span ``train.backward``, over the window's steps."""

SPANS = ("train.backward",)


def read(w):
    s = w.trace.span_device_s(SPANS)
    return 1e3 * s / w.units if s > 0 else None
