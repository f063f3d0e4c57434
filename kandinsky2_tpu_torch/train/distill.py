"""Progressive step distillation (Salimans & Ho 2022), the counterpart of
``kandinsky2_tpu/train/distill.py`` on one device.

A student copy of the decoder UNet learns to cover two teacher DDIM steps
in one of its own, so each round halves the sampling ladder.  The teacher
and the student are {name: tensor} dicts run on one module through the
``eps_fn`` contract of ``train_lora`` (``unet22_eps_fn``); the teacher's
two steps run without a graph and are expressed as an x0 target
("target prediction", the paper's Appendix G), and the loss carries the
truncated-SNR weight max(1, ā/(1 − ā)) (the paper's eq. 9).

Each step draws the student's ladder index i, then the noise, from the
state's generator unless the caller passes them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .tensor_state import TensorTrainState, init_tensor_state


def init_distill_state(teacher_params: dict, optimizer_factory: Callable,
                       seed: int = 0) -> TensorTrainState:
    """The student, a trainable copy of ``teacher_params`` in their dtypes
    (cast them first for fp32 masters of a bf16 teacher), with
    ``optimizer_factory(student tensors)`` and a generator seeded with
    ``seed``."""
    return init_tensor_state(teacher_params, optimizer_factory, seed)


def _abar(acp, t):
    return acp[t].reshape((-1, 1, 1, 1))


def ddim_step(eps_fn: Callable, params: dict, acp, x, t, t_next, cond):
    """One deterministic DDIM step t -> t_next (eta = 0)."""
    eps = eps_fn(params, x, t.float(), cond).float()
    a_t, a_n = _abar(acp, t), _abar(acp, t_next)
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_n) * x0 + torch.sqrt(1.0 - a_n) * eps


@torch.no_grad()
def teacher_x0_target(eps_fn: Callable, teacher_params: dict, acp, x_t, t, d: int,
                      cond):
    """The x0 from which one student step t -> t − 2d lands where two
    teacher DDIM steps t -> t − d -> t − 2d land: solve
    z = √ā_n x0 + √(1 − ā_n) ε with ε = (x_t − √ā_t x0)/√(1 − ā_t)."""
    z_mid = ddim_step(eps_fn, teacher_params, acp, x_t, t, t - d, cond)
    z_next = ddim_step(eps_fn, teacher_params, acp, z_mid, t - d, t - 2 * d, cond)
    a_t, a_n = _abar(acp, t), _abar(acp, t - 2 * d)
    ratio = torch.sqrt((1.0 - a_n) / (1.0 - a_t))
    return (z_next - ratio * x_t) / (torch.sqrt(a_n) - ratio * torch.sqrt(a_t))


def make_distill_step(eps_fn: Callable, teacher_params: dict, alphas_cumprod, *,
                      num_student_steps: int = 500):
    """``train_step(state, x0, cond, i=None, noise=None)``, one step in
    place, returning {"loss"}.

    The student's ladder is the uniform ``ddpm_ladder(num_student_steps)``
    grid: it trains at t = 2·d·i for i in [1, num_student_steps), with
    d = num_train_steps // (2·num_student_steps), where num_train_steps is
    the length of ``alphas_cumprod``, so the trained timesteps are exactly
    the ladder the distilled student samples on."""
    num_train_steps = len(alphas_cumprod)
    if num_train_steps % (2 * num_student_steps) != 0:
        raise ValueError(
            f"num_student_steps={num_student_steps} must divide "
            f"{num_train_steps}//2 exactly — otherwise the high-noise tail "
            "of the process is never trained (pick e.g. "
            f"{num_train_steps // 2}, {num_train_steps // 4}, ...)"
        )
    d = num_train_steps // (2 * num_student_steps)
    if d < 1:
        raise ValueError(
            f"num_student_steps={num_student_steps} too large for a "
            f"{num_train_steps}-step base process"
        )
    device = next(iter(teacher_params.values())).device
    acp = torch.as_tensor(np.asarray(alphas_cumprod, np.float32), device=device)

    def train_step(state: TensorTrainState, x0, cond, i=None, noise=None) -> dict:
        B = x0.shape[0]
        if i is None:
            i = torch.randint(1, num_student_steps, (B,), generator=state.generator,
                              device=device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=state.generator, device=device)
        t = torch.as_tensor(i, device=device).long() * 2 * d
        noise = torch.as_tensor(noise, device=device).float()
        a_t = _abar(acp, t)
        x_t = torch.sqrt(a_t) * x0.float() + torch.sqrt(1.0 - a_t) * noise
        x0_target = teacher_x0_target(eps_fn, teacher_params, acp, x_t, t, d, cond)
        w = torch.clamp(a_t / (1.0 - a_t), min=1.0)
        eps_s = eps_fn(state.params, x_t, t.float(), cond).float()
        x0_s = (x_t - torch.sqrt(1.0 - a_t) * eps_s) / torch.sqrt(a_t)
        loss = (w * (x0_s - x0_target) ** 2).mean()
        loss.backward()
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return {"loss": loss.detach()}

    return train_step
