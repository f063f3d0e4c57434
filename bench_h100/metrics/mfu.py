"""The whole step's share of the card's bf16 peak: the flops of every
model call of the untraced window (work/counter.py, from the
configuration's shapes) over that window's wall time and 989 TFLOP/s.
One reader for every cell's ``mfu.<cell kind>``."""

from bench_h100.work.counter import PEAKS


def read(w):
    f = w.work.flops * w.wall_units
    return 100.0 * f / (w.wall_s * PEAKS["bf16_flops"]) if f > 0 else None
