"""Atomic checkpoint save and resume, the counterpart of
``kandinsky2_tpu/train/checkpoint.py``, with ``torch.save`` in place of
safetensors.

* ``save_checkpoint`` / ``load_checkpoint`` — the inference weights, a flat
  {name: tensor} state_dict (what ships).
* ``save_train_state`` / ``restore_train_state`` — the whole train state
  (``TrainState.state_dict()``: parameters, optimizer state, EMA shadow,
  loss-aware sampler history, step and the generator's state), so a run
  that is killed and resumed is bitwise identical to one that was not.

Every write goes to a temporary file and is renamed into place, then a
``latest`` / ``latest_state`` marker names the newest file.  Files are read
back with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch


def _atomic_save(obj, fname: str) -> None:
    tmp = fname + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, fname)


def _write_marker(path: str, marker: str, step: int, fname: str) -> None:
    tmp = os.path.join(path, marker + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"step": step, "file": os.path.basename(fname)}, f)
    os.replace(tmp, os.path.join(path, marker))


def _read_marker(path: str, marker: str):
    fname = os.path.join(path, marker)
    if not os.path.exists(fname):
        return None, 0
    with open(fname) as f:
        meta = json.load(f)
    return os.path.join(path, meta["file"]), int(meta["step"])


def save_checkpoint(path: str, state_dict: dict, step: int) -> str:
    """Write ``<path>/ckpt_<step>.pt`` (the weights, on the host) and the
    ``latest`` marker."""
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"ckpt_{step:08d}.pt")
    _atomic_save({k: v.detach().cpu() for k, v in state_dict.items()}, fname)
    _write_marker(path, "latest", step, fname)
    return fname


def latest_checkpoint(path: str):
    """(filename, step) of the newest weight export, or (None, 0)."""
    return _read_marker(path, "latest")


def load_checkpoint(fname: str) -> dict:
    return torch.load(fname, map_location="cpu", weights_only=True)


def save_train_state(path: str, state, step: Optional[int] = None) -> str:
    """Write ``<path>/state_<step>.pt`` from ``state.state_dict()`` (or
    ``state`` itself where it is that dict already, ``step`` then given)
    and the ``latest_state`` marker."""
    step = state.step if step is None else step
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"state_{step:08d}.pt")
    _atomic_save(state if isinstance(state, dict) else state.state_dict(), fname)
    _write_marker(path, "latest_state", step, fname)
    return fname


def latest_train_state(path: str):
    """(filename, step) of the newest whole-state checkpoint, or (None, 0)."""
    return _read_marker(path, "latest_state")


def restore_train_state(fname: str, state) -> None:
    """Load a whole train state into ``state`` (built the same way as the one
    that was saved) in place; ``state.load_state_dict`` raises if the
    structure drifted."""
    state.load_state_dict(torch.load(fname, map_location="cpu", weights_only=True))
