"""Device milliseconds of the frozen encoders a step (MoVQ encode, XLM-R,
CLIP ViT): the ops launched inside the benchmark's span
``bench.prepare_batch``, over the window's steps."""

SPANS = ("bench.prepare_batch",)


def read(w):
    s = w.trace.span_device_s(SPANS)
    return 1e3 * s / w.units if s > 0 else None
