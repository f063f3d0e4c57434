"""The train state of a step over a flat {key: tensor} dict of trainable
tensors: LoRA's factors (``train_lora``, keyed ``<weight>.down`` and
``<weight>.up``) and a distillation student (``distill``).

The state holds the tensors (leaves with a gradient), their optimizer,
the generator of the step's draws and the step count: everything a bitwise
resume through ``checkpoint.save_train_state`` / ``restore_train_state``
needs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class TensorTrainState:
    params: dict
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0

    def state_dict(self) -> dict:
        return {"params": {n: p.detach().clone() for n, p in self.params.items()},
                "optimizer": self.optimizer.state_dict(), "step": self.step,
                "generator": self.generator.get_state()}

    def load_state_dict(self, saved: dict) -> None:
        """Restore in place; raise ValueError if the saved tensors are not
        this state's (keys or shapes)."""
        shapes = lambda ps: {n: tuple(p.shape) for n, p in ps.items()}
        if shapes(saved["params"]) != shapes(self.params):
            raise ValueError("the saved tensors do not match this state's: "
                             "the structure changed since it was saved")
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(saved["params"][name])
        self.optimizer.load_state_dict(saved["optimizer"])
        self.step = int(saved["step"])
        self.generator.set_state(saved["generator"])


def init_tensor_state(tensors: dict, optimizer_factory: Callable,
                      seed: int = 0) -> TensorTrainState:
    """A state over trainable copies of ``tensors`` (in their dtypes), with
    ``optimizer_factory(list of the copies)`` and a generator seeded with
    ``seed`` on their device."""
    params = {n: t.detach().clone().requires_grad_() for n, t in tensors.items()}
    device = next(iter(params.values())).device
    return TensorTrainState(
        params=params, optimizer=optimizer_factory(list(params.values())),
        generator=torch.Generator(device=device).manual_seed(seed))
