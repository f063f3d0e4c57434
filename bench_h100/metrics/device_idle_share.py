"""Share of the traced window in which no op ran on the card: one minus
the union of the device ops' intervals over the traced window.  One
reader for every cell's ``device_idle_share.<cell kind>``."""


def read(w):
    busy = w.trace.busy_s
    return 100.0 * (1.0 - busy / w.window_s) if busy > 0 else None
