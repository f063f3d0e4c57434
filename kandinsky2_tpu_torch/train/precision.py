"""Mixed-precision helpers, the counterpart of
``kandinsky2_tpu/train/precision.py`` (reference: kandinsky2/model/
fp16_util.py).

* ``cast_params`` / ``cast_torso`` cast the floating tensors of a
  {name: tensor} dict (returning a new dict) or of a module (in place);
  ``cast_torso`` keeps the norms and biases fp32, as convert_module_to_f16
  keeps its norms (fp16_util.py:9-26).
* ``fp32_master_optimizer`` wraps an optimizer factory so that the update
  is computed on fp32 masters of the live parameters, which may be bf16
  (the make_master_params pattern, fp16_util.py:29-52).

The JAX package keeps a leaf fp32 where its path ends in ``scale`` or
``bias``.  The port's state_dict names end in ``weight`` for a kernel, an
embedding and a norm's scale alike, so the rule reads a norm's scale as
the 1-D ``weight``: every kernel and embedding is at least 2-D.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


def _keeps_fp32(name: str, tensor: torch.Tensor) -> bool:
    return name.endswith("bias") or (name.endswith("weight") and tensor.dim() == 1)


def _cast(params, dtype, keep: Callable[[str, torch.Tensor], bool]):
    if isinstance(params, nn.Module):
        with torch.no_grad():
            for name, p in params.named_parameters():
                if p.is_floating_point() and not keep(name, p):
                    p.data = p.data.to(dtype)
        return params
    return {name: (t.to(dtype) if t.is_floating_point() and not keep(name, t) else t)
            for name, t in params.items()}


def cast_params(params, dtype):
    """Every floating tensor cast to ``dtype``."""
    return _cast(params, dtype, lambda name, t: False)


def cast_torso(params, dtype, keep_fp32: Optional[Callable[[str], bool]] = None):
    """``cast_params`` except the tensors whose name ``keep_fp32`` accepts,
    which stay fp32: by default the norms' scales and every bias."""
    keep = _keeps_fp32 if keep_fp32 is None else (lambda name, t: keep_fp32(name))
    return _cast(params, dtype, keep)


class FP32MasterOptimizer:
    """An optimizer over live (possibly bf16) parameters that steps an inner
    optimizer on fp32 masters: each ``step`` upcasts the live gradients onto
    the masters, steps, and writes the masters back cast to the live dtype.
    ``state_dict`` holds the inner optimizer's state and the masters."""

    def __init__(self, params, optimizer_factory: Callable):
        self.live = list(params)
        self.masters = [p.detach().float().clone().requires_grad_() for p in self.live]
        self.inner = optimizer_factory(self.masters)

    @torch.no_grad()
    def step(self):
        for p, m in zip(self.live, self.masters):
            m.grad = None if p.grad is None else p.grad.float()
        self.inner.step()
        for p, m in zip(self.live, self.masters):
            p.copy_(m)

    def zero_grad(self, set_to_none: bool = True):
        for p in self.live:
            p.grad = None
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {**self.inner.state_dict(),
                "masters": [m.detach().clone() for m in self.masters]}

    def load_state_dict(self, saved: dict) -> None:
        saved = dict(saved)
        with torch.no_grad():
            for m, s in zip(self.masters, saved.pop("masters")):
                m.copy_(s)
        self.inner.load_state_dict(saved)


def fp32_master_optimizer(optimizer_factory: Callable) -> Callable:
    """An optimizer factory (params -> optimizer) whose optimizer keeps fp32
    masters of the parameters it is given and runs
    ``optimizer_factory(masters)`` on them."""
    return lambda params: FP32MasterOptimizer(params, optimizer_factory)
