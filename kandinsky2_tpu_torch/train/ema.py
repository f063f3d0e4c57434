"""Exponential moving average of parameters, the counterpart of
``kandinsky2_tpu/train/ema.py`` (reference: kandinsky2/train_utils/
ema.py:5-66: shadow buffers with the warm-up decay
min(decay, (1 + n) / (10 + n))).  The shadow is updated in place."""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def ema_decay_at(decay: float, num_updates: Optional[int]) -> float:
    """The decay of update ``num_updates`` in fp32, as the JAX package
    computes it; ``None`` for a fixed decay."""
    if num_updates is None:
        return float(np.float32(decay))
    n = np.float32(num_updates)
    return float(min(np.float32(decay), (np.float32(1) + n) / (np.float32(10) + n)))


@torch.no_grad()
def ema_update(ema_params: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], decay: float,
               num_updates: Optional[int] = None) -> None:
    """One EMA step over matching names: e = e·d + p·(1 − d), in place."""
    d = ema_decay_at(decay, num_updates)
    one_minus = float(np.float32(1) - np.float32(d))
    for name, e in ema_params.items():
        e.mul_(d).add_(params[name].to(e.dtype), alpha=one_minus)
