"""Device milliseconds of one CFG-batched decoder UNet call: the device
time of the ops launched inside the span ``k22.unet_ddpm`` (the decoder
loop), over the UNet calls of the window."""

SPANS = ("k22.unet_ddpm",)


def read(w):
    s, n = w.trace.span_device_s(SPANS), w.counts.get("unet_calls")
    return 1e3 * s / n if s > 0 and n else None
