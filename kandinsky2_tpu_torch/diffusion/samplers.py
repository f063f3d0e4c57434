"""Denoising loops as Python loops over tensors, the counterpart of
``kandinsky2_tpu/diffusion/samplers.py``: the ancestral loop, DDIM over a
respaced schedule and over a ladder, PLMS and DPM-Solver++(2M), with their
tables.

``model_fn(x, t_model)`` takes the useful batch B (classifier-free guidance
doubling is the model_fn's business) and float32 [B] model timesteps, and
returns the guidance-mixed output.

Stateful variant (``model_state`` argument): when a loop receives an
initial ``model_state``, ``model_fn(x, t_model, state, pos) -> (out,
state)`` and the state is carried from step to step; ``pos`` is the
0-based ladder position, so the model can decide its refresh steps (the
turbo deep cache).

Per-step noise comes from ``noise_seq`` [num_steps, *x.shape] where given
(ordered from the first step taken), else from ``generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import schedules as _sched
from .gaussian import (
    MeanType,
    Schedule,
    VarType,
    extract,
    p_mean_variance,
    predict_eps_from_xstart,
)


def _step_noise(generator, noise_seq, pos: int, x: torch.Tensor) -> torch.Tensor:
    if noise_seq is not None:
        return noise_seq[pos].to(x)
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)


def _call(model_fn, x, ts, state, pos, stateful):
    """One model call: ``(out in fp32, state)``."""
    if stateful:
        out, state = model_fn(x, ts, state, pos)
    else:
        out = model_fn(x, ts)
    return out.float(), state


def p_sample_loop(
    model_fn: Callable,
    sched: Schedule,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    mean_type: MeanType = MeanType.EPSILON,
    var_type: VarType = VarType.LEARNED_RANGE,
    clip_denoised: bool = True,
    denoised_fn: Optional[Callable] = None,
    init_step: Optional[int] = None,
    noise_seq: Optional[torch.Tensor] = None,
    channel_axis: int = 1,
    model_state=None,
) -> torch.Tensor:
    """Ancestral sampling (gaussian_diffusion.py:352-475, samplers.py:65 of
    the JAX package).  ``init_step`` truncates the ladder for img2img
    (gaussian_diffusion.py:453-455): the loop runs t = init_step-1 down."""
    num = sched.num_timesteps if init_step is None else init_step
    B = x_T.shape[0]
    x = x_T.float()
    state = model_state
    for pos, i in enumerate(range(num - 1, -1, -1)):
        t = torch.full((B,), i, dtype=torch.int64, device=x.device)
        model_out, state = _call(model_fn, x, sched.model_timesteps(t), state, pos,
                                 model_state is not None)
        out = p_mean_variance(
            sched, model_out, x, t, mean_type=mean_type, var_type=var_type,
            clip_denoised=clip_denoised, denoised_fn=denoised_fn,
            channel_axis=channel_axis,
        )
        noise = _step_noise(generator, noise_seq, pos, x)
        x = out["mean"] if i == 0 else (
            out["mean"] + torch.exp(0.5 * out["log_variance"]) * noise)
    return x


def ddim_respaced_loop(
    model_fn: Callable,
    sched: Schedule,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    mean_type: MeanType = MeanType.EPSILON,
    var_type: VarType = VarType.LEARNED_RANGE,
    clip_denoised: bool = True,
    denoised_fn: Optional[Callable] = None,
    eta: float = 0.0,
    noise_seq: Optional[torch.Tensor] = None,
    channel_axis: int = 1,
) -> torch.Tensor:
    """DDIM over a respaced schedule (gaussian_diffusion.py:477-635), the
    prior's "ddim…" ladder."""
    num = sched.num_timesteps
    B = x_T.shape[0]
    x = x_T.float()
    nd = x.ndim
    for pos, i in enumerate(range(num - 1, -1, -1)):
        t = torch.full((B,), i, dtype=torch.int64, device=x.device)
        model_out = model_fn(x, sched.model_timesteps(t)).float()
        out = p_mean_variance(
            sched, model_out, x, t, mean_type=mean_type, var_type=var_type,
            clip_denoised=clip_denoised, denoised_fn=denoised_fn,
            channel_axis=channel_axis,
        )
        eps = predict_eps_from_xstart(sched, x, t, out["pred_xstart"])
        alpha_bar = extract(sched.alphas_cumprod, t, nd)
        alpha_bar_prev = extract(sched.alphas_cumprod_prev, t, nd)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        x = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
             + torch.sqrt(1 - alpha_bar_prev - sigma**2) * eps)
        if eta != 0.0 and i != 0:
            x = x + sigma * _step_noise(generator, noise_seq, pos, x)
    return x


class DDIMTables(NamedTuple):
    """Per-ladder-step constants of the DDIM and PLMS samplers
    (samplers.py:82-149), float64 on the host, float32 on the device."""

    timesteps: np.ndarray  # int [S] ladder values fed to the model
    alphas: torch.Tensor  # float32 [S]
    alphas_prev: torch.Tensor
    sqrt_one_minus_alphas: torch.Tensor
    sigmas: torch.Tensor


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def make_ddim_tables(
    base_alphas_cumprod: np.ndarray,
    num_steps: int,
    *,
    num_ddpm_steps: int = 1000,
    eta: float = 0.0,
    init_step: Optional[int] = None,
    device=None,
) -> DDIMTables:
    """The ladder and tables of DDIMSampler.make_schedule (samplers.py:82-149),
    with the img2img truncation to entries <= ``init_step``
    (samplers.py:11-18)."""
    if len(base_alphas_cumprod) != num_ddpm_steps:
        raise ValueError(
            "make_ddim_tables needs the base (un-respaced) alphas_cumprod of "
            f"length {num_ddpm_steps}, got {len(base_alphas_cumprod)}"
        )
    ladder = _sched.ddim_ladder(num_steps, num_ddpm_steps, init_step=init_step)
    sigmas, alphas, alphas_prev = _sched.ddim_sampling_parameters(
        np.asarray(base_alphas_cumprod, dtype=np.float64), ladder, eta
    )
    return DDIMTables(
        timesteps=np.asarray(ladder, np.int64),
        alphas=_f32(alphas, device),
        alphas_prev=_f32(alphas_prev, device),
        sqrt_one_minus_alphas=_f32(np.sqrt(1.0 - alphas), device),
        sigmas=_f32(sigmas, device),
    )


def _ddim_update(tables: DDIMTables, x, e_t, index, noise=None):
    """x_{t-1} from eps at ladder ``index`` (samplers.py:310-331); ``noise``
    is scaled by the table's sigma (None where eta = 0)."""
    a_t = tables.alphas[index]
    a_prev = tables.alphas_prev[index]
    sigma_t = tables.sigmas[index]
    pred_x0 = (x - tables.sqrt_one_minus_alphas[index] * e_t) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(1.0 - a_prev - sigma_t**2) * e_t
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
    if noise is not None:
        x_prev = x_prev + sigma_t * noise
    return x_prev


def _ladder_t(tables, index: int, B: int, device) -> torch.Tensor:
    return torch.full((B,), float(tables.timesteps[index]), dtype=torch.float32,
                      device=device)


def ddim_loop(
    model_fn: Callable,
    tables: DDIMTables,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    eta: float = 0.0,
    noise_seq: Optional[torch.Tensor] = None,
    model_state=None,
) -> torch.Tensor:
    """Latent-diffusion DDIM loop (samplers.py:205-331).  ``model_fn``
    returns eps only; with ``eta`` > 0 (tables built with the same eta)
    each step adds sigma-scaled noise."""
    total = len(tables.timesteps)
    B = x_T.shape[0]
    x = x_T.float()
    state = model_state
    for pos in range(total):
        index = total - pos - 1
        e_t, state = _call(model_fn, x, _ladder_t(tables, index, B, x.device), state,
                           pos, model_state is not None)
        noise = None if eta == 0.0 else _step_noise(generator, noise_seq, pos, x)
        x = _ddim_update(tables, x, e_t, index, noise)
    return x


class DPMTables(NamedTuple):
    """Per-step constants of DPM-Solver++(2M) in walk order (pos 0 = the
    largest t), float64 on the host, float32 on the device
    (samplers.py:284)."""

    timesteps: np.ndarray  # float32 [S] values fed to the model
    alpha: torch.Tensor  # sqrt(abar_t)
    sigma: torch.Tensor  # sqrt(1 - abar_t)
    sigma_ratio: torch.Tensor  # sigma_{t_next} / sigma_t
    alpha_next: torch.Tensor  # sqrt(abar_{t_next})
    phi: torch.Tensor  # expm1(-h), h = lambda_next - lambda
    c2: torch.Tensor  # h / (2 h_prev); 0 at pos 0 (first-order start)


def make_dpmpp_tables(
    base_alphas_cumprod: np.ndarray,
    num_steps: Optional[int] = None,
    *,
    num_ddpm_steps: int = 1000,
    init_step: Optional[int] = None,
    ladder: Optional[np.ndarray] = None,
    device=None,
) -> DPMTables:
    """DPM-Solver++(2M) tables over the reference's uniform DDIM ladder
    (with the LDM final target abar[0]), or over an explicit descending
    ``ladder`` whose final step targets abar = 1 (samplers.py:305)."""
    if len(base_alphas_cumprod) != num_ddpm_steps:
        raise ValueError(
            "make_dpmpp_tables needs the base (un-respaced) alphas_cumprod "
            f"of length {num_ddpm_steps}, got {len(base_alphas_cumprod)}"
        )
    abar = np.asarray(base_alphas_cumprod, dtype=np.float64)
    if ladder is None:
        if num_steps is None:
            raise ValueError("pass num_steps or an explicit ladder")
        asc = _sched.ddim_ladder(num_steps, num_ddpm_steps, init_step=init_step)
        _, alphas, alphas_prev = _sched.ddim_sampling_parameters(abar, asc, 0.0)
        cur, nxt, ladder_desc = alphas[::-1], alphas_prev[::-1], asc[::-1]
    else:
        ladder_desc = np.asarray(ladder, np.int64)
        if len(ladder_desc) > 1 and ladder_desc[0] < ladder_desc[-1]:
            raise ValueError("explicit ladder must be descending (walk order)")
        cur = abar[ladder_desc]
        nxt = np.append(abar[ladder_desc[1:]], 1.0)
    return _dpm_tables_from_abar(
        cur, nxt, np.ascontiguousarray(ladder_desc).astype(np.float64), device)


def _dpm_tables_from_abar(cur, nxt, t_values, device=None) -> DPMTables:
    """The 2M table math from walk-order abar pairs and the model-facing t
    values (samplers.py:354)."""
    with np.errstate(divide="ignore"):
        lam = lambda a: 0.5 * (np.log(a) - np.log1p(-a))
        h = lam(nxt) - lam(cur)  # > 0 while denoising; inf on a final abar = 1
    c2 = np.zeros_like(h)
    c2[1:] = np.where(np.isinf(h[1:]), 0.0, h[1:] / (2.0 * h[:-1]))
    return DPMTables(
        timesteps=np.asarray(t_values, np.float32),
        alpha=_f32(np.sqrt(cur), device),
        sigma=_f32(np.sqrt(1.0 - cur), device),
        sigma_ratio=_f32(np.sqrt((1.0 - nxt) / (1.0 - cur)), device),
        alpha_next=_f32(np.sqrt(nxt), device),
        phi=_f32(np.expm1(-h), device),  # expm1(-inf) = -1: the last step emits x0
        c2=_f32(c2, device),
    )


def make_dpmpp_tables_from_respaced(sched: Schedule, device=None) -> DPMTables:
    """2M tables from a respaced ``Schedule`` (the prior's "dpmpp…" ladder,
    samplers.py:373): the kept steps' alphas_cumprod, alphas_cumprod_prev as
    the walk targets, and the model-facing t through ``timestep_map``."""
    acp = sched.alphas_cumprod.cpu().numpy().astype(np.float64)
    prev = sched.alphas_cumprod_prev.cpu().numpy().astype(np.float64)
    tm = sched.timestep_map.cpu().numpy().astype(np.float64)
    if sched.rescale_timesteps:
        tm = tm * (1000.0 / sched.original_num_steps)
    return _dpm_tables_from_abar(acp[::-1], prev[::-1], tm[::-1], device)


def make_dpmpp_karras_tables(
    base_alphas_cumprod: np.ndarray,
    num_steps: int,
    *,
    num_ddpm_steps: int = 1000,
    rho: float = 7.0,
    init_step: Optional[int] = None,
    device=None,
) -> DPMTables:
    """DPM-Solver++(2M) tables over a Karras sigma grid, each sigma mapped
    to a continuous model timestep by log-sigma interpolation; the final
    step targets abar = 1 (samplers.py:388).  ``init_step`` caps sigma_max
    for img2img."""
    if len(base_alphas_cumprod) != num_ddpm_steps:
        raise ValueError(
            "make_dpmpp_karras_tables needs the base (un-respaced) "
            f"alphas_cumprod of length {num_ddpm_steps}"
        )
    abar = np.asarray(base_alphas_cumprod, dtype=np.float64)
    sig_grid = np.sqrt((1.0 - abar) / abar)  # ascending in t
    t_hi = num_ddpm_steps - 1 if init_step is None else min(
        max(init_step - 1, 1), num_ddpm_steps - 1)
    smin, smax = sig_grid[0], sig_grid[t_hi]
    ramp = np.linspace(0.0, 1.0, num_steps)
    sigmas = (smax ** (1.0 / rho)
              + ramp * (smin ** (1.0 / rho) - smax ** (1.0 / rho))) ** rho
    t_cont = np.interp(np.log(sigmas), np.log(sig_grid), np.arange(num_ddpm_steps))
    cur = 1.0 / (1.0 + sigmas**2)
    nxt = np.append(cur[1:], 1.0)
    return _dpm_tables_from_abar(cur, nxt, t_cont, device)


def dpmpp_2m_loop(
    model_fn: Callable,
    tables: DPMTables,
    x_T: torch.Tensor,
    *,
    prediction: str = "epsilon",
    denoised_fn: Optional[Callable] = None,
    model_state=None,
) -> torch.Tensor:
    """Deterministic DPM-Solver++(2M) loop (samplers.py:427).  ``model_fn``
    returns eps, or the x0 prediction with ``prediction="xstart"`` (the
    prior's convention); ``denoised_fn`` post-processes each x0."""
    if prediction not in ("epsilon", "xstart"):
        raise ValueError(f"prediction must be 'epsilon' or 'xstart', got {prediction}")
    B = x_T.shape[0]
    x = x_T.float()
    x0_prev = torch.zeros_like(x)
    state = model_state
    for pos in range(len(tables.timesteps)):
        out, state = _call(model_fn, x, _ladder_t(tables, pos, B, x.device), state,
                           pos, model_state is not None)
        x0 = out if prediction == "xstart" else (
            (x - tables.sigma[pos] * out) / tables.alpha[pos])
        if denoised_fn is not None:
            x0 = denoised_fn(x0)
        c = tables.c2[pos]  # 0 at pos 0: D = x0
        D = (1.0 + c) * x0 - c * x0_prev
        x = tables.sigma_ratio[pos] * x - tables.alpha_next[pos] * tables.phi[pos] * D
        x0_prev = x0
    return x


def plms_loop(
    model_fn: Callable,
    tables: DDIMTables,
    x_T: torch.Tensor,
    *,
    model_state=None,
) -> torch.Tensor:
    """PLMS (samplers.py:474-637): the first step is the pseudo improved
    Euler of two model calls (both at ``pos`` 0), then Adams-Bashforth
    blends of order 2, 3 and 4 by the length of the eps history."""
    total = len(tables.timesteps)
    B = x_T.shape[0]
    x = x_T.float()
    stateful = model_state is not None
    state = model_state
    index0 = total - 1
    e_t, state = _call(model_fn, x, _ladder_t(tables, index0, B, x.device), state,
                       0, stateful)
    x_prev0 = _ddim_update(tables, x, e_t, index0)
    e_next, state = _call(model_fn, x_prev0,
                          _ladder_t(tables, max(total - 2, 0), B, x.device), state,
                          0, stateful)
    x = _ddim_update(tables, x, (e_t + e_next) / 2, index0)
    hist = [e_t]  # most recent last, at most three kept
    for pos in range(1, total):
        index = total - pos - 1
        e_t, state = _call(model_fn, x, _ladder_t(tables, index, B, x.device), state,
                           pos, stateful)
        if len(hist) == 1:
            e_prime = (3 * e_t - hist[-1]) / 2
        elif len(hist) == 2:
            e_prime = (23 * e_t - 16 * hist[-1] + 5 * hist[-2]) / 12
        else:
            e_prime = (55 * e_t - 59 * hist[-1] + 37 * hist[-2] - 9 * hist[-3]) / 24
        x = _ddim_update(tables, x, e_prime, index)
        hist = (hist + [e_t])[-3:]
    return x
