"""The traced window, reduced in memory: ``torch.profiler`` over the
window, then its raw kineto events cut down to arrays of device ops
(kernels, copies, sets), host ops and ``record_function`` spans.  No
chrome trace is written.

Each device op carries the host time of the runtime call that launched
it (matched by correlation id), so a span's device time is the time of
the ops launched while the span was open on the host."""

from __future__ import annotations

import contextlib
from collections import defaultdict

import numpy as np

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, events):
        dev, host, spans, launch = [], [], defaultdict(list), {}
        for e in events:
            kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
            start, dur = e.start_ns(), e.duration_ns()
            if str(e.device_type()).endswith("CPU"):
                host.append((start, start + dur, e.name()))
                if e.is_user_annotation():
                    spans[e.name()].append((start, start + dur))
                elif kind == "cuda_runtime" or e.name().startswith(("cuda", "cu")):
                    launch[e.correlation_id()] = start
            elif not e.is_user_annotation() and (kind in DEVICE_ACTIVITIES or not kind):
                dev.append((start, start + dur, e.name(), e.correlation_id()))
        dev.sort()
        self.dev_start = np.array([d[0] for d in dev], np.int64)
        self.dev_end = np.array([d[1] for d in dev], np.int64)
        self.dev_name = [d[2] for d in dev]
        self.dev_launch = np.array([launch.get(d[3], -1) for d in dev], np.int64)
        host.sort()
        self.host_start = np.array([h[0] for h in host], np.int64)
        self.host_end = np.array([h[1] for h in host], np.int64)
        self.host_name = [h[2] for h in host]
        self.spans = {k: np.array(sorted(v), np.int64).reshape(-1, 2) for k, v in spans.items()}

    @property
    def busy_s(self) -> float:
        """Seconds in which some op ran on the device (the union of ops)."""
        return sum(e - s for s, e in self._busy()) / 1e9

    def _busy(self):
        out = []
        for s, e in zip(self.dev_start.tolist(), self.dev_end.tolist()):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def _named(self, names) -> np.ndarray:
        return np.array([any(n in d for n in names) for d in self.dev_name], bool)

    def kernel_s(self, names) -> float:
        """Device seconds of the ops whose name contains one of ``names``."""
        m = self._named(names)
        return float((self.dev_end[m] - self.dev_start[m]).sum()) / 1e9

    def span_host_s(self, name: str) -> float:
        """Host seconds inside the span ``name``, over its occurrences."""
        iv = self.spans.get(name)
        return 0.0 if iv is None else float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def span_device_s(self, names) -> float:
        """Device seconds of the ops launched inside the spans ``names``."""
        inside = np.zeros(len(self.dev_name), bool)
        for name in names:
            iv = self.spans.get(name)
            if iv is None or not len(iv):
                continue
            k = np.searchsorted(iv[:, 0], self.dev_launch, side="right") - 1
            ok = k >= 0
            inside[ok] |= self.dev_launch[ok] <= iv[k[ok], 1]
        return float((self.dev_end[inside] - self.dev_start[inside]).sum()) / 1e9

    def top_device_ops(self, n: int = 10):
        tot = defaultdict(int)
        for name, s, e in zip(self.dev_name, self.dev_start.tolist(), self.dev_end.tolist()):
            tot[name] += e - s
        return [[k[:200], v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """The longest gaps between device ops, each named by the innermost
        host op open at its middle."""
        busy = self._busy()
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                      reverse=True)[:n]
        out = []
        for length, s, e in gaps:
            mid = (s + e) // 2
            m = np.nonzero((self.host_start <= mid) & (self.host_end >= mid))[0]
            name = self.host_name[m[np.argmax(self.host_start[m])]] if len(m) else "(none)"
            out.append([name[:200], length / 1e9])
        return out


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the block on the host and the card; yields a holder whose
    ``events`` are the raw kineto events once the block has ended.  The
    host's record of every aten op slows the host-bound phases (a 2.2 call
    3.77–4.36 s traced against 2.69–3.11 s untraced, a batch-32 training
    step 1.51 s against 1.21 s, on one card), which is why the harness
    reads host-clock metrics from the untraced window.  CUDA activity
    alone costs about 5 % but records no ``record_function`` span."""
    holder = type("Traced", (), {"events": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        yield holder
    finally:
        prof.stop()
        holder.events = prof.profiler.kineto_results.events()
