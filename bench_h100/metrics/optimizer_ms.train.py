"""Device milliseconds of the optimizer's step a training step: the ops
launched inside the span ``Optimizer.step#Adafactor.step`` that
torch.optim opens, over the window's steps.  (The span's host time is no
measure once the card sets the pace: the host then waits inside it for
room in the launch queue.)"""

SPANS = ("Optimizer.step#Adafactor.step",)


def read(w):
    s = w.trace.span_device_s(SPANS)
    return 1e3 * s / w.units if s > 0 else None
