"""Denoising loops as Python loops over tensors: the subset of
``kandinsky2_tpu/diffusion/samplers.py`` on the 2.1 text2img path.

``model_fn(x, t_model)`` takes the useful batch B (classifier-free guidance
doubling is the model_fn's business) and float32 [B] model timesteps, and
returns the guidance-mixed output.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import schedules as _sched
from .gaussian import MeanType, Schedule, VarType, p_mean_variance


def p_sample_loop(
    model_fn: Callable,
    sched: Schedule,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    mean_type: MeanType = MeanType.START_X,
    var_type: VarType = VarType.FIXED_SMALL,
    denoised_fn: Optional[Callable] = None,
    noise_seq: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ancestral sampling (gaussian_diffusion.py:352-475, samplers.py:58-126
    of the JAX package).  ``noise_seq`` [num_steps, *x.shape] injects the
    per-step noise, ordered from t = T-1 down; otherwise it is drawn from
    ``generator``."""
    num = sched.num_timesteps
    B = x_T.shape[0]
    x = x_T.float()
    for pos, i in enumerate(range(num - 1, -1, -1)):
        t = torch.full((B,), i, dtype=torch.int64, device=x.device)
        model_out = model_fn(x, sched.model_timesteps(t))
        out = p_mean_variance(
            sched, model_out.float(), x, t, mean_type=mean_type,
            var_type=var_type, denoised_fn=denoised_fn,
        )
        if noise_seq is not None:
            noise = noise_seq[pos].to(x)
        else:
            noise = torch.randn(
                x.shape, generator=generator, device=x.device, dtype=x.dtype
            )
        if i == 0:
            x = out["mean"]
        else:
            x = out["mean"] + torch.exp(0.5 * out["log_variance"]) * noise
    return x


class DDIMTables(NamedTuple):
    """Per-ladder-step constants for the DDIM sampler (samplers.py:82-149),
    float64 on the host, float32 on the device."""

    timesteps: np.ndarray  # int [S] ladder values fed to the model
    alphas: torch.Tensor  # float32 [S]
    alphas_prev: torch.Tensor
    sqrt_one_minus_alphas: torch.Tensor
    sigmas: torch.Tensor


def make_ddim_tables(
    base_alphas_cumprod: np.ndarray,
    num_steps: int,
    *,
    num_ddpm_steps: int = 1000,
    eta: float = 0.0,
    device=None,
) -> DDIMTables:
    """The ladder and tables of DDIMSampler.make_schedule (samplers.py:82-149)."""
    if len(base_alphas_cumprod) != num_ddpm_steps:
        raise ValueError(
            "make_ddim_tables needs the base (un-respaced) alphas_cumprod of "
            f"length {num_ddpm_steps}, got {len(base_alphas_cumprod)}"
        )
    ladder = _sched.ddim_ladder(num_steps, num_ddpm_steps)
    sigmas, alphas, alphas_prev = _sched.ddim_sampling_parameters(
        np.asarray(base_alphas_cumprod, dtype=np.float64), ladder, eta
    )
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return DDIMTables(
        timesteps=np.asarray(ladder, np.int64),
        alphas=f32(alphas),
        alphas_prev=f32(alphas_prev),
        sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
        sigmas=f32(sigmas),
    )


def _ddim_update(tables: DDIMTables, x, e_t, index):
    """x_{t-1} from eps at ladder ``index`` with eta = 0 (samplers.py:310-331)."""
    a_t = tables.alphas[index]
    a_prev = tables.alphas_prev[index]
    sigma_t = tables.sigmas[index]
    pred_x0 = (x - tables.sqrt_one_minus_alphas[index] * e_t) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(1.0 - a_prev - sigma_t**2) * e_t
    return torch.sqrt(a_prev) * pred_x0 + dir_xt


def ddim_loop(model_fn: Callable, tables: DDIMTables, x_T: torch.Tensor):
    """Deterministic (eta = 0) latent-diffusion DDIM loop (samplers.py:205-331)."""
    total = len(tables.timesteps)
    B = x_T.shape[0]
    x = x_T.float()
    for pos in range(total):
        index = total - pos - 1
        ts = torch.full(
            (B,), float(tables.timesteps[index]), dtype=torch.float32,
            device=x.device,
        )
        e_t = model_fn(x, ts).float()
        x = _ddim_update(tables, x, e_t, index)
    return x
