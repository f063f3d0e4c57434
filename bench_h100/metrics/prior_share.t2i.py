"""Share of the window's wall time spent in the prior stage: the host
seconds inside the spans ``k22.clip_text`` and ``k22.prior`` (the prior's
loop is host-bound, so its host span is its wall time), over the window."""

SPANS = ("k22.clip_text", "k22.prior")


def read(w):
    s = sum(w.trace.span_host_s(name) for name in SPANS)
    return 100.0 * s / w.window_s if s > 0 else None
