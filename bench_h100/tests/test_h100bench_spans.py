"""The readers of the program's spans on synthetic traces with known span
and device intervals: each device op attributed to the span open at its
launch, spans selected by the span they nest in, idle time clipped to the
spans, and None where a span is absent.  On a card: a kernel launched
inside a span is attributed to it, and starts on the device no earlier
than the span on the host (one clock for both)."""

from __future__ import annotations

import pytest
import torch

from bench_h100 import run, spans
from bench_h100.trace import Trace


class Event:
    """The face of a kineto event that ``Trace`` reads."""

    def __init__(self, name, start, end, device="CPU", annotation=False, corr=0,
                 kind=None):
        self._name, self._start, self._dur = name, start, end - start
        self._device, self._annotation, self._corr, self._kind = device, annotation, corr, kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return f"DeviceType.{self._device}"

    def is_user_annotation(self):
        return self._annotation

    def correlation_id(self):
        return self._corr

    def activity_type(self):
        return self._kind


def make_trace(span_list, ops):
    """``span_list``: (name, start, end) host spans; ``ops``: (launch time,
    device start, device end) kernels, each launched by its own runtime
    call."""
    events = [Event(n, s, e, annotation=True) for n, s, e in span_list]
    for corr, (launch, s, e) in enumerate(ops, 1):
        events.append(Event("cudaLaunchKernel", launch, launch + 1, corr=corr,
                            kind="cuda_runtime"))
        events.append(Event(f"k{corr}", s, e, device="CUDA", corr=corr, kind="kernel"))
    return Trace(events)


def window(trace, units=1):
    return run.Window(trace, 1.0, units, {}, None, 0, 1.0, units)


def read(metric, trace, units=1):
    return run.load_reader(metric).read(window(trace, units))


MS = 1_000_000  # nanoseconds


def train_trace():
    """Two steps: forward [0, 10) and [100, 110) ms, backward [10, 30) and
    [110, 130), EMA [30, 32) and [130, 132); kernels launched in each,
    one launched between spans, one outside every span."""
    span_list = []
    for base in (0, 100):
        span_list += [("train.forward", base * MS, (base + 10) * MS),
                      ("train.backward", (base + 10) * MS, (base + 30) * MS),
                      ("train.ema", (base + 30) * MS, (base + 32) * MS)]
    ops = [(1 * MS, 2 * MS, 5 * MS),        # forward: 3 ms
           (101 * MS, 102 * MS, 106 * MS),  # forward: 4 ms
           (12 * MS, 12 * MS, 22 * MS),     # backward: 10 ms
           (111 * MS, 120 * MS, 126 * MS),  # backward: 6 ms
           (31 * MS, 40 * MS, 41 * MS),     # EMA, run after its span closed: 1 ms
           (131 * MS, 131 * MS, 133 * MS),  # EMA: 2 ms
           (50 * MS, 50 * MS, 60 * MS)]     # launched outside every span
    return make_trace(span_list, ops)


def test_device_ms_readers_attribute_each_op_to_the_span_open_at_its_launch():
    t = train_trace()
    assert read("forward_ms.train", t, units=2) == pytest.approx(3.5)
    assert read("backward_ms.train", t, units=2) == pytest.approx(8.0)
    assert read("ema_ms.train", t, units=2) == pytest.approx(1.5)


def test_backward_idle_share_clips_the_device_ops_to_the_span():
    """Backward spans [10, 30) and [110, 130) ms: busy [12, 22) and
    [120, 126) inside, 16 of 40 ms; the forward's [2, 5) and the op
    launched outside, [50, 60), lie outside and count for nothing."""
    t = train_trace()
    assert read("backward_idle_share.train", t) == pytest.approx(100 * (1 - 16 / 40))
    # an op that straddles the span's end counts only up to it
    t = make_trace([("train.backward", 0, 10 * MS)], [(0, 8 * MS, 20 * MS)])
    assert read("backward_idle_share.train", t) == pytest.approx(80.0)
    # overlapping ops count once (the union, as busy_s takes it)
    t = make_trace([("train.backward", 0, 10 * MS)],
                   [(0, 1 * MS, 4 * MS), (0, 2 * MS, 6 * MS), (0, 9 * MS, 12 * MS)])
    assert read("backward_idle_share.train", t) == pytest.approx(100 * (1 - 6 / 10))


def t2i_trace():
    """A call: the prior [0, 30) ms with two model calls, the decoder loop
    [40, 100) with three, and one model call outside both."""
    span_list = [("k22.prior", 0, 30 * MS), ("k22.unet_ddpm", 40 * MS, 100 * MS),
                 ("diffusion.model", 5 * MS, 15 * MS), ("diffusion.model", 15 * MS, 25 * MS),
                 ("diffusion.model", 45 * MS, 55 * MS), ("diffusion.model", 60 * MS, 70 * MS),
                 ("diffusion.model", 80 * MS, 90 * MS),
                 ("diffusion.model", 110 * MS, 120 * MS)]
    ops = [(5 * MS, 6 * MS, 8 * MS),      # prior call 1: 2 of 10 ms busy
           (15 * MS, 24 * MS, 27 * MS),   # prior call 2: 1 of 10 ms (to its end)
           (45 * MS, 45 * MS, 55 * MS),   # decoder call 1: all 10 ms
           (60 * MS, 62 * MS, 67 * MS),   # decoder call 2: 5 ms
           (75 * MS, 75 * MS, 85 * MS),   # launched between calls, runs into call 3: 5 ms
           (110 * MS, 110 * MS, 120 * MS)]  # the model call outside both
    return make_trace(span_list, ops)


def test_model_calls_are_selected_by_the_span_they_nest_in():
    t = t2i_trace()
    assert len(spans.nested(t, "diffusion.model", ("k22.prior",))) == 2
    assert len(spans.nested(t, "diffusion.model", ("k22.unet_",))) == 3
    assert len(spans.intervals(t, "diffusion.model")) == 6
    assert read("prior_idle_share.t2i", t) == pytest.approx(100 * (1 - 3 / 20))
    assert read("unet_idle_share.t2i", t) == pytest.approx(100 * (1 - 20 / 30))


def test_readers_return_none_where_their_span_is_absent():
    t = make_trace([("k22.unet_ddpm", 0, 10 * MS)], [(0, 1 * MS, 2 * MS)])
    for metric in ("forward_ms.train", "backward_ms.train", "ema_ms.train",
                   "backward_idle_share.train", "unet_idle_share.t2i",
                   "prior_idle_share.t2i"):
        assert read(metric, t) is None, metric
    # model calls with no prior around them, and a trace with no device op
    t = make_trace([("k22.unet_ddpm", 0, 10 * MS), ("diffusion.model", 1 * MS, 2 * MS)],
                   [(0, 1 * MS, 2 * MS)])
    assert read("prior_idle_share.t2i", t) is None and read("unet_idle_share.t2i", t) == 0.0
    t = make_trace([("train.backward", 0, 10 * MS)], [])
    assert read("backward_idle_share.train", t) is None


@pytest.mark.cuda
def test_a_kernel_launched_in_a_span_is_attributed_to_it_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(4096, 4096, device="cuda")
    y = x @ x
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        y = y @ x
        with record_function("train.forward"):
            for _ in range(3):
                y = y @ x
        y = y @ x
        torch.cuda.synchronize()
    t = Trace(prof.profiler.kineto_results.events())
    (start, end), = t.spans["train.forward"].tolist()
    inside = (t.dev_launch >= start) & (t.dev_launch <= end)
    assert inside.sum() >= 3 and (t.dev_launch > end).any()
    # launched inside the span, so queued behind the product before it: on
    # one clock each starts on the card after the span opened on the host
    assert (t.dev_start[inside] >= start).all()
    want = float((t.dev_end[inside] - t.dev_start[inside]).sum()) / 1e9
    assert 0 < t.span_device_s(["train.forward"]) == pytest.approx(want)
    assert read("forward_ms.train", t) == pytest.approx(1e3 * want)
