"""Training-timestep sampling, the counterpart of
``kandinsky2_tpu/train/resample.py`` (reference: kandinsky2/model/
resample.py).

* ``uniform_sample`` — UniformSampler (resample.py:57-63).
* ``LossSecondMomentSampler`` — LossSecondMomentResampler
  (resample.py:115-145): importance weights from the square root of the
  second moment of each timestep's recent losses, uniform until every
  timestep has a full history.

Draws come from an explicit ``torch.Generator``.  The two frameworks' random
numbers differ, so the tests hand both the same timesteps.
"""

from __future__ import annotations

import torch


def uniform_sample(generator: torch.Generator, num_timesteps: int,
                   batch_size: int):
    """(timesteps [B] int64, importance weights = 1)."""
    dev = generator.device
    t = torch.randint(0, num_timesteps, (batch_size,), generator=generator,
                      device=dev)
    return t, torch.ones((batch_size,), dtype=torch.float32, device=dev)


class LossSecondMomentSampler:
    """Loss-aware timestep sampler.  ``history`` [T, history_per_term] and
    ``counts`` [T] live on the host; ``state_dict`` carries them through a
    checkpoint."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.history = torch.zeros((num_timesteps, history_per_term))
        self.counts = torch.zeros((num_timesteps,), dtype=torch.int64)
        self.uniform_prob = uniform_prob

    def weights(self) -> torch.Tensor:
        """sqrt of the mean squared loss per timestep, normalised and mixed
        with ``uniform_prob`` of the uniform; all ones until warmed up
        (resample.py:125-132)."""
        T, H = self.history.shape
        if not bool((self.counts == H).all()):
            return torch.ones((T,))
        w = torch.sqrt((self.history ** 2).mean(-1))
        w = w / torch.clamp(w.sum(), min=1e-12)
        return w * (1 - self.uniform_prob) + self.uniform_prob / T

    def importance(self, t: torch.Tensor) -> torch.Tensor:
        """1 / (T p_t) for timesteps ``t`` (resample.py:39-54)."""
        w = self.weights()
        p = w / w.sum()
        return (1.0 / (p.shape[0] * p[t.cpu()])).float().to(t.device)

    def sample(self, generator: torch.Generator, batch_size: int):
        """(timesteps drawn with probability p, importance weights)."""
        w = self.weights()
        p = (w / w.sum()).to(generator.device)
        t = torch.multinomial(p, batch_size, replacement=True, generator=generator)
        return t, self.importance(t)

    def update(self, ts: torch.Tensor, losses: torch.Tensor, axis=None) -> None:
        """Append each (t, loss) to t's history, first in first out once full
        (resample.py:134-142), in batch order.  With ``axis`` (a
        ``parallel.mesh.MeshAxis``), every shard's batch is all-gathered
        over it first, in axis order, so every shard updates identically
        (resample.py:77-98)."""
        if axis is not None:
            from ..parallel.collectives import all_gather

            ts = all_gather(ts.detach().reshape(-1), axis)
            losses = all_gather(losses.detach().float().reshape(-1), axis)
        H = self.history.shape[1]
        for t, loss in zip(ts.tolist(), losses.detach().float().cpu().tolist()):
            c = int(self.counts[t])
            if c == H:
                self.history[t] = torch.cat([self.history[t, 1:],
                                             torch.tensor([loss])])
            else:
                self.history[t, c] = loss
                self.counts[t] = c + 1

    def state_dict(self) -> dict:
        return {"history": self.history.clone(), "counts": self.counts.clone()}

    def load_state_dict(self, state: dict) -> None:
        self.history.copy_(state["history"])
        self.counts.copy_(state["counts"])
