"""What the idle-share readers share: a span's intervals, those nested in
another span, and the share of their host time in which no op ran on the
card.  A span is nested in a parent when its host start lies inside one of
the parent's intervals; the idle time is the part of the intervals outside
the union of the device ops (``Trace.busy_s``'s union), clipped to them."""

from __future__ import annotations

import numpy as np

NO_INTERVALS = np.zeros((0, 2), np.int64)


def intervals(trace, name: str) -> np.ndarray:
    """[n, 2] host (start, end) of every occurrence of the span ``name``."""
    return trace.spans.get(name, NO_INTERVALS)


def nested(trace, name: str, parents: tuple) -> np.ndarray:
    """The intervals of ``name`` that start inside an interval of a span
    whose name starts with one of ``parents``."""
    iv = intervals(trace, name)
    inside = np.zeros(len(iv), bool)
    for parent, piv in trace.spans.items():
        if parent.startswith(parents) and len(piv):
            k = np.searchsorted(piv[:, 0], iv[:, 0], side="right") - 1
            ok = k >= 0
            inside[ok] |= iv[ok, 0] <= piv[k[ok], 1]
    return iv[inside]


def busy_within(trace, iv: np.ndarray) -> int:
    """Nanoseconds of ``iv`` in which some op ran on the card."""
    busy = np.array(trace._busy(), np.int64).reshape(-1, 2)
    if not len(busy) or not len(iv):
        return 0
    done = np.concatenate([[0], np.cumsum(busy[:, 1] - busy[:, 0])])

    def upto(x):  # busy nanoseconds before time x
        k = np.searchsorted(busy[:, 0], x, side="right") - 1
        part = np.where(k >= 0, np.minimum(x, busy[k, 1]) - busy[k, 0], 0)
        return done[np.maximum(k, 0)] * (k >= 0) + part

    return int((upto(iv[:, 1]) - upto(iv[:, 0])).sum())


def idle_share(trace, iv: np.ndarray):
    """Percent of the host time inside ``iv`` in which no op ran on the
    card; None where there are no intervals or the trace holds no device
    op (a run without a card)."""
    total = int((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0
    if total <= 0 or not len(trace.dev_start):
        return None
    return 100.0 * (1.0 - busy_within(trace, iv) / total)
