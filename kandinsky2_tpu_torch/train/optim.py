"""Adafactor with optax's defaults, and the decoder's freeze mask.

``Adafactor`` is the counterpart of ``optax.adafactor`` (optax 0.2.6,
``optax/_src/alias.py`` ``adafactor`` and ``_src/factorized.py``
``scale_by_factored_rms``), which the YAML's ``optim_params`` name.  Per
parameter tensor, in the order optax chains them:

1. factored second moments: for a tensor whose two largest dims are both at
   least 128, row and column means of g² + 1e-30 decayed with
   1 − (step + 1)^−0.8, and the update
   g · (v_row / mean(v_row))^−½ · v_col^−½; other tensors keep a full v and
   get g · v^−½;
2. block-RMS clipping: u / max(1, rms(u));
3. the learning rate;
4. the parameter scale: u · max(rms(p), 1e-3) on the parameter before the
   step;
5. p ← p − u.

Only the learning rate is an argument: the YAML's ``optim_params`` set
nothing else, so optax's other defaults are constants here.

``torch.optim.Adafactor`` follows another recipe (relative step sizes, its
own decay and epsilons), so it is not used.

Layouts differ (torch OI / OIHW against flax IO / HWIO), but the factored
pair is always the two largest dims, so a tensor factors over the same
axes in both; only where those two dims are equal can the row and column
roles swap, which changes nothing but rounding.

``decoder_freeze_mask`` is ``kandinsky2_tpu/train/train_unclip.py``'s, on
the port's parameter names (the reference's state_dict names): the
freeze applies as ``requires_grad_(False)``, and the optimizer holds only
the trainable parameters (the counterpart of ``masked_optimizer``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

RES_MARKERS = ("in_layers", "h_upd", "x_upd", "emb_layers", "out_layers")
ATTN_MARKERS = ("proj_out", "qkv")


def decoder_freeze_mask(module: torch.nn.Module, freeze_resblocks: bool = False,
                        freeze_attention: bool = False) -> dict[str, bool]:
    """{parameter name: trainable} with freeze_decoder's name rules
    (train_utils/utils.py:212-229)."""

    def trainable(name: str) -> bool:
        name = name.lower()
        if any(m in name for m in RES_MARKERS):
            return not freeze_resblocks
        if any(m in name for m in ATTN_MARKERS):
            return not freeze_attention
        return True

    return {name: trainable(name) for name, _ in module.named_parameters()}


def apply_freeze_mask(module: torch.nn.Module, mask: dict[str, bool]) -> list:
    """Set ``requires_grad`` from ``mask``; returns the trainable
    parameters in ``named_parameters`` order."""
    params = []
    for name, p in module.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return params


# optax.adafactor's defaults
MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
EPS = 1e-30


def _factored_dims(shape) -> Optional[tuple[int, int]]:
    """(second largest, largest) dim if both are big enough, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape, kind="stable")
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(learning_rate)`` (no momentum, no weight decay) as a
    torch optimizer; the state per tensor is ``step`` and either ``v_row``
    and ``v_col`` or ``v``, in the parameter's dtype."""

    def __init__(self, params, learning_rate: float):
        super().__init__(params, dict(learning_rate=learning_rate))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adafactor takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.sub_(self._update(p, p.grad, group["learning_rate"]))

    def _update(self, p, grad, learning_rate: float) -> torch.Tensor:
        state = self.state[p]
        dims = _factored_dims(tuple(p.shape))
        if not state:
            state["step"] = 0
            if dims is None:
                state["v"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state["v_row"] = torch.zeros_like(p).mean(d0)
                state["v_col"] = torch.zeros_like(p).mean(d1)
        # optax's schedule 1 - (step + 1)^-rate, in fp32 as optax computes it
        step = np.float32(state["step"] + 1)
        decay = np.float32(1) - step ** np.float32(-DECAY_RATE)
        keep, mix = float(decay), float(np.float32(1) - decay)
        grad_sqr = grad * grad + EPS
        if dims is None:
            v = state["v"].mul_(keep).add_(grad_sqr, alpha=mix)
            u = grad * v.rsqrt()
        else:
            d1, d0 = dims
            v_row = state["v_row"].mul_(keep).add_(grad_sqr.mean(d0), alpha=mix)
            v_col = state["v_col"].mul_(keep).add_(grad_sqr.mean(d1), alpha=mix)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)).rsqrt()
            u = grad * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
        state["step"] += 1
        u = u / torch.clamp(_rms(u), min=1.0)  # clipping threshold 1
        return u * learning_rate * torch.clamp(_rms(p), min=1e-3)


def adafactor_from_config(optim_params: dict):
    """The optimizer factory a training YAML's ``optim_params`` names: only
    ``optax.adafactor`` with only ``learning_rate`` (optax's other defaults
    are constants here); anything else raises NotImplementedError."""
    if optim_params["name"] != "optax.adafactor":
        raise NotImplementedError(
            f"optimizer {optim_params['name']}: the port has Adafactor only")
    opt_kw = optim_params["params"]
    if set(opt_kw) != {"learning_rate"}:
        raise NotImplementedError(
            f"Adafactor options {sorted(opt_kw)}: the port takes learning_rate "
            "only, with optax's other defaults")
    return lambda params: Adafactor(params, opt_kw["learning_rate"])
