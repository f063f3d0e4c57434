"""Gaussian diffusion math on tensors: the subset of
``kandinsky2_tpu/diffusion/gaussian.py`` that the 2.1 text2img path runs.

Tables are built in float64 numpy (``schedules.py``) and stored as float32
tensors on the caller's device, as the JAX package stores them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import numpy as np
import torch

from . import schedules as _sched


class MeanType(enum.Enum):
    """What the model predicts (gaussian_diffusion.py:64-71)."""

    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class VarType(enum.Enum):
    """How the model variance is produced (gaussian_diffusion.py:74-84)."""

    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


@dataclasses.dataclass
class Schedule:
    """Per-timestep constants of a (possibly respaced) process, float32
    tensors of shape [num_timesteps]."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    timestep_map: torch.Tensor  # int64
    base_alphas_cumprod: np.ndarray  # float64 host copy, for DDIM tables
    num_timesteps: int
    original_num_steps: int
    rescale_timesteps: bool

    def model_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        """Compressed timestep indices -> values fed to the model
        (respace.py:128-133)."""
        new_t = self.timestep_map[t].float()
        if self.rescale_timesteps:
            return new_t * (1000.0 / self.original_num_steps)
        return new_t


def make_schedule(
    *,
    steps: int = 1000,
    noise_schedule: str = "linear",
    timestep_respacing="",
    linear_start: float = 0.0001,
    linear_end: float = 0.02,
    rescale_timesteps: bool = False,
    device=None,
) -> Schedule:
    """Mirrors ``kandinsky2_tpu.diffusion.make_schedule``: float64 numpy
    math, then one cast to float32 tensors."""
    base_betas = _sched.named_betas(noise_schedule, steps, linear_start, linear_end)
    if not timestep_respacing:
        timestep_respacing = [steps]
    use_timesteps = _sched.space_timesteps(steps, timestep_respacing)
    betas, timestep_map = _sched.respace_betas(base_betas, use_timesteps)

    betas = np.asarray(betas, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:])
    )
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Schedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        ),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        timestep_map=torch.as_tensor(timestep_map, dtype=torch.int64, device=device),
        base_alphas_cumprod=np.asarray(
            np.float32(alphas_cumprod), np.float64
        ),
        num_timesteps=int(betas.shape[0]),
        original_num_steps=steps,
        rescale_timesteps=rescale_timesteps,
    )


def extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep constants and broadcast against an ndim tensor
    (gaussian_diffusion.py:816-828).  ``t`` is a [B] integer tensor."""
    out = arr[t]
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


def predict_xstart_from_eps(sched: Schedule, x_t, t, eps):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * eps
    )


def q_posterior_mean(sched: Schedule, x_start, x_t, t):
    """Mean of q(x_{t-1} | x_t, x_0) (gaussian_diffusion.py:201-221)."""
    nd = x_t.ndim
    return (
        extract(sched.posterior_mean_coef1, t, nd) * x_start
        + extract(sched.posterior_mean_coef2, t, nd) * x_t
    )


def p_mean_variance(
    sched: Schedule,
    model_output: torch.Tensor,
    x: torch.Tensor,
    t: torch.Tensor,
    *,
    mean_type: MeanType,
    var_type: VarType,
    denoised_fn: Optional[Callable] = None,
):
    """p(x_{t-1} | x_t) for an x0- or eps-predicting model with the fixed
    small variance (gaussian_diffusion.py:223-322), the prior's ladder.
    Dynamic thresholding (``clip_denoised``) is not on the slice's path.

    Returns dict(mean, log_variance, pred_xstart)."""
    if var_type != VarType.FIXED_SMALL:
        raise NotImplementedError(f"var_type {var_type} is not ported yet")
    nd = x.ndim
    log_variance = extract(sched.posterior_log_variance_clipped, t, nd).expand(
        x.shape
    )
    if mean_type == MeanType.START_X:
        pred_xstart = model_output
    elif mean_type == MeanType.EPSILON:
        pred_xstart = predict_xstart_from_eps(sched, x, t, model_output)
    else:
        raise NotImplementedError(mean_type)
    if denoised_fn is not None:
        pred_xstart = denoised_fn(pred_xstart)
    mean = q_posterior_mean(sched, pred_xstart, x, t)
    return {"mean": mean, "log_variance": log_variance, "pred_xstart": pred_xstart}
