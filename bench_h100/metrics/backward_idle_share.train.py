"""Share of the host time inside the program's span ``train.backward`` in
which no op ran on the card (the device ops' union clipped to the span's
intervals): how far the autograd engine's launches fall behind the card.
Stretched by the profiler, like ``device_idle_share``."""

from bench_h100.spans import idle_share, intervals


def read(w):
    return idle_share(w.trace, intervals(w.trace, "train.backward"))
