"""Per-stage timing, profiler traces, progress ticks and a NaN/Inf guard,
the counterpart of ``kandinsky2_tpu/observability.py``.

* :func:`stage_timer` / :class:`StageReport`: wall time per named stage,
  fenced with :func:`sync` (``torch.cuda.synchronize`` on the tensor's
  card; a no-op on the CPU), so a stage's time includes the device work it
  queued.
* :func:`trace`: a ``torch.profiler`` context writing a trace to a
  directory (TensorBoard's profiler plugin or Perfetto read it).
* :func:`progress`: a progress tick for a Python sampler loop (the JAX
  package's ``scan_progress`` lives inside a ``lax.scan``; eager loops have
  no scan, so this is a plain call).
* :func:`guard_finite`: a NaN/Inf check behind the module flag
  ``GUARD_NANS``; it costs nothing when off, and one host sync per call
  when on.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Optional

import torch

GUARD_NANS = False  # flip on for debugging; each guarded call syncs the host


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def sync(x):
    """Wait for the card that holds ``x``'s first tensor (a tensor, or a
    list, tuple or dict of them); nothing to wait for on the CPU.  Returns
    ``x``."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return x


class StageReport:
    """Collects named wall times; ``str(report)`` is the summary."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result_to_sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if result_to_sync is not None:
                sync(result_to_sync)
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def __str__(self):
        total = sum(self.times.values())
        lines = [
            f"  {k:<24} {v*1e3:9.1f} ms ({v/total*100:5.1f}%)"
            for k, v in self.times.items()
        ]
        return "\n".join(lines + [f"  {'total':<24} {total*1e3:9.1f} ms"])


@contextlib.contextmanager
def stage_timer(report: Optional[StageReport], name: str):
    if report is None:
        yield
        return
    with report.stage(name):
        yield


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over the block (the card's kernels too where there
    is one), its trace written into ``log_dir`` (a directory under the
    temporary directory by default); yields the directory."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "kandinsky2_tpu_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


def progress(pos: int, total: int, label: str = "step", every: int = 1) -> None:
    """Print ``label pos+1/total`` in place every ``every`` steps and at the
    last."""
    if pos % every == 0 or pos == total - 1:
        print(f"\r{label} {pos + 1}/{total}", end="", flush=True)


def guard_finite(x: torch.Tensor, name: str) -> torch.Tensor:
    """With ``GUARD_NANS`` on, print a warning naming ``name`` when ``x``
    holds a NaN or an Inf (one host sync); returns ``x`` unchanged."""
    if not GUARD_NANS:
        return x
    if not bool(torch.isfinite(x.float()).all()):
        print(f"!! non-finite values in {name}")
    return x
