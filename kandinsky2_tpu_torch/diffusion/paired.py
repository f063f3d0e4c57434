"""Paired-timestep ancestral sampling, the 2.2 scheduler family: the
counterpart of ``kandinsky2_tpu/diffusion/paired.py``.

The 2.2 prior runs diffusers' UnCLIPScheduler (sample prediction,
fixed_small_log variance, clip ±10, cosine betas) and the decoder its
DDPMScheduler (epsilon prediction, learned_range variance, clip ±2).  Both
recompute the step's beta from the *base* alphas_cumprod at a (t, prev_t)
pair of a ladder, which is what ``paired_ancestral_loop`` walks.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .samplers import _call, _step_noise

__all__ = ["ddpm_ladder", "unclip_ladder", "paired_ancestral_loop"]


def ddpm_ladder(num_inference_steps: int, num_train_steps: int = 1000) -> np.ndarray:
    """diffusers DDPMScheduler.set_timesteps: arange * (T // S), descending."""
    ratio = num_train_steps // num_inference_steps
    return (np.arange(0, num_inference_steps) * ratio).round().astype(np.int64)[::-1]


def unclip_ladder(num_inference_steps: int, num_train_steps: int = 1000) -> np.ndarray:
    """diffusers UnCLIPScheduler.set_timesteps: the same uniform striding."""
    return ddpm_ladder(num_inference_steps, num_train_steps)


def paired_ancestral_loop(
    model_fn: Callable,
    base_alphas_cumprod,
    timesteps: np.ndarray,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    prediction: str = "epsilon",  # "epsilon" | "sample"
    variance: str = "learned_range",  # "learned_range" | "fixed_small_log" | "fixed_small"
    clip_range: Optional[float] = 2.0,
    channel_axis: int = -1,
    noise_seq: Optional[torch.Tensor] = None,
    model_state=None,
) -> torch.Tensor:
    """Walk the (t, prev_t) ladder ``timesteps`` (descending) from x_T.
    ``model_fn(x, t)`` returns the guidance-mixed prediction, its variance
    channels concatenated along ``channel_axis`` when ``variance`` is
    "learned_range"; with ``model_state``, ``model_fn(x, t, state, pos) ->
    (out, state)`` and the state is carried (the turbo deep cache).  Step
    ``pos`` adds ``noise_seq[pos]`` where given, else a draw from
    ``generator``; the last step adds none."""
    ts = np.asarray(timesteps, np.int64)
    prev = np.concatenate([ts[1:], [-1]])
    acp = np.asarray(torch.as_tensor(base_alphas_cumprod).cpu(), np.float32)
    B = x_T.shape[0]
    dev = x_T.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    x = x_T.float()
    state = model_state
    for pos, (t, t_prev) in enumerate(zip(ts, prev)):
        # the step's scalars in fp32, as the JAX scan computes them
        a_t = f32(acp[t])
        a_prev = f32(acp[t_prev] if t_prev >= 0 else 1.0)
        alpha = a_t / a_prev
        beta = 1.0 - alpha
        out, state = _call(model_fn, x, torch.full((B,), float(t), device=dev), state,
                           pos, model_state is not None)
        if variance == "learned_range":
            out, var_values = out.chunk(2, dim=channel_axis)
        if prediction == "epsilon":
            x0 = (x - torch.sqrt(1.0 - a_t) * out) / torch.sqrt(a_t)
        else:
            x0 = out
        if clip_range is not None:
            x0 = torch.clamp(x0, -clip_range, clip_range)
        mean = ((beta * torch.sqrt(a_prev) / (1.0 - a_t)) * x0
                + ((1.0 - a_prev) * torch.sqrt(alpha) / (1.0 - a_t)) * x)
        if t_prev < 0:
            x = mean
            continue
        beta_tilde = (1.0 - a_prev) / (1.0 - a_t) * beta
        if variance == "learned_range":
            min_log = torch.log(torch.clamp(beta_tilde, min=1e-20))
            max_log = torch.log(torch.clamp(beta, min=1e-20))
            frac = (var_values + 1.0) / 2.0
            scale = torch.exp(0.5 * (frac * max_log + (1.0 - frac) * min_log))
        elif variance == "fixed_small_log":
            scale = torch.exp(0.5 * torch.log(torch.clamp(beta_tilde, min=1e-20)))
        else:  # fixed_small
            scale = torch.sqrt(torch.clamp(beta_tilde, min=1e-20))
        x = mean + scale * _step_noise(generator, noise_seq, pos, x)
    return x
