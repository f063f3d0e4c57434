"""Share of the host time inside the prior's model calls (the spans
``diffusion.model`` nested in ``k22.prior``) in which no op ran on the
card: the host's part in a prior call.  Stretched by the profiler, like
``device_idle_share``."""

from bench_h100.spans import idle_share, nested


def read(w):
    return idle_share(w.trace, nested(w.trace, "diffusion.model", ("k22.prior",)))
