"""The 2.1 trainer's update, fp32: ``optax.adafactor`` with the YAML's
arguments (factored second moments decayed by 1 − (step + 1)^−0.8, the
update clipped to RMS 1, times the learning rate and the parameter's RMS)
and the EMA with its warm-up decay min(decay, (1 + n) / (10 + n))."""

from __future__ import annotations

import numpy as np
import torch


def factored_dims(shape, min_dim: int = 128):
    """(second largest, largest) dim where both reach ``min_dim``, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape, kind="stable")
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """State per tensor: ``v_row``/``v_col`` or ``v``; ``step`` is shared."""

    def __init__(self, params, lr: float, decay_rate: float = 0.8, eps: float = 1e-30,
                 clip: float = 1.0):
        self.params = list(params)
        self.lr, self.decay_rate, self.eps, self.clip = lr, decay_rate, eps, clip
        self.state = [{} for _ in self.params]
        self.step_count = 0

    @torch.no_grad()
    def step(self):
        t = np.float32(self.step_count + 1)
        decay = float(np.float32(1) - t ** np.float32(-self.decay_rate))
        for p, st in zip(self.params, self.state):
            g = p.grad.float()
            g2 = g * g + self.eps
            dims = factored_dims(tuple(p.shape))
            if dims is None:
                st["v"] = st.get("v", torch.zeros_like(g)) * decay + g2 * (1 - decay)
                u = g * st["v"].rsqrt()
            else:
                d1, d0 = dims
                st["v_row"] = (st.get("v_row", torch.zeros_like(g2.mean(d0))) * decay
                               + g2.mean(d0) * (1 - decay))
                st["v_col"] = (st.get("v_col", torch.zeros_like(g2.mean(d1))) * decay
                               + g2.mean(d1) * (1 - decay))
                red = d1 - 1 if d1 > d0 else d1
                row = (st["v_row"] / st["v_row"].mean(red, keepdim=True)).rsqrt()
                u = g * row.unsqueeze(d0) * st["v_col"].rsqrt().unsqueeze(d1)
            rms = lambda x: torch.sqrt(torch.mean(x * x))
            u = u / torch.clamp(rms(u) / self.clip, min=1.0)
            u = u * self.lr * torch.clamp(rms(p.float()), min=1e-3)
            p.sub_(u.to(p.dtype))
        self.step_count += 1


@torch.no_grad()
def ema_update(ema: dict, params: dict, decay: float, n: int) -> None:
    d = float(min(np.float32(decay), (np.float32(1) + np.float32(n)) / (np.float32(10)
                                                                      + np.float32(n))))
    for name, e in ema.items():
        e.mul_(d).add_(params[name].float(), alpha=float(np.float32(1) - np.float32(d)))

