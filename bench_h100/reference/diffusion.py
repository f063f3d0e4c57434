"""Diffusion arithmetic of the two configurations, fp32 tensors from
float64 tables: the paired-timestep ancestral step of the 2.2 prior and
decoder (diffusers UnCLIPScheduler and DDPMScheduler) and the hybrid
MSE + VLB training loss of the 2.1 decoder (guided-diffusion)."""

from __future__ import annotations

import math

import numpy as np
import torch


def named_betas(name: str, steps: int, start: float = 1e-4, end: float = 0.02):
    if name == "linear":
        scale = 1000.0 / steps
        return np.linspace(scale * start, scale * end, steps, dtype=np.float64)
    if name == "cosine":
        bar = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return np.array([min(1 - bar((i + 1) / steps) / bar(i / steps), 0.999)
                         for i in range(steps)], dtype=np.float64)
    raise ValueError(name)


def alphas_cumprod(name: str, steps: int = 1000, start: float = 1e-4,
                   end: float = 0.02) -> np.ndarray:
    return np.cumprod(1.0 - named_betas(name, steps, start, end)).astype(np.float32)


def ladder(steps: int, train_steps: int = 1000) -> np.ndarray:
    """The descending uniform timestep ladder of diffusers' set_timesteps."""
    return (np.arange(0, steps) * (train_steps // steps)).round().astype(np.int64)[::-1]


def paired_step(out, x, acp, t: int, t_prev: int, noise, *, prediction: str,
                variance: str, clip: float):
    """One ancestral step from x at ``t`` to ``t_prev`` (-1: the last, which
    adds no noise) given the guided model output ``out`` (with the learned
    variance channels after the eps ones for "learned_range")."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    a_t = f32(acp[t])
    a_prev = f32(acp[t_prev] if t_prev >= 0 else 1.0)
    alpha = a_t / a_prev
    beta = 1.0 - alpha
    if variance == "learned_range":
        out, var_values = out.chunk(2, dim=-1)
    x0 = (x - torch.sqrt(1.0 - a_t) * out) / torch.sqrt(a_t) if prediction == "epsilon" else out
    x0 = torch.clamp(x0, -clip, clip)
    mean = ((beta * torch.sqrt(a_prev) / (1.0 - a_t)) * x0
            + ((1.0 - a_prev) * torch.sqrt(alpha) / (1.0 - a_t)) * x)
    if t_prev < 0:
        return mean
    beta_tilde = (1.0 - a_prev) / (1.0 - a_t) * beta
    if variance == "learned_range":
        lo = torch.log(torch.clamp(beta_tilde, min=1e-20))
        hi = torch.log(torch.clamp(beta, min=1e-20))
        frac = (var_values + 1.0) / 2.0
        scale = torch.exp(0.5 * (frac * hi + (1.0 - frac) * lo))
    else:  # fixed_small_log
        scale = torch.exp(0.5 * torch.log(torch.clamp(beta_tilde, min=1e-20)))
    return mean + scale * noise


class Schedule:
    """The 1000-step linear schedule of the 2.1 decoder, as float32 tensors."""

    def __init__(self, steps: int, start: float, end: float, device=None):
        betas = named_betas("linear", steps, start, end)
        acp = np.cumprod(1.0 - betas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        self.num_timesteps = steps
        self.sqrt_acp = f32(np.sqrt(acp))
        self.sqrt_1m_acp = f32(np.sqrt(1.0 - acp))
        self.sqrt_recip_acp = f32(np.sqrt(1.0 / acp))
        self.sqrt_recipm1_acp = f32(np.sqrt(1.0 / acp - 1))
        self.post_var = f32(post_var)
        self.post_logvar = f32(np.log(np.append(post_var[1], post_var[1:])))
        self.coef1 = f32(betas * np.sqrt(acp_prev) / (1.0 - acp))
        self.coef2 = f32((1.0 - acp_prev) * np.sqrt(1.0 - betas) / (1.0 - acp))
        self.log_betas = f32(np.log(betas))


def _at(a, t):
    return a[t][:, None, None, None]


def _normal_kl(m1, lv1, m2, lv2):
    return 0.5 * (-1.0 + lv2 - lv1 + torch.exp(lv1 - lv2) + (m1 - m2) ** 2 * torch.exp(-lv2))


def _cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _discretized_loglik(x, means, log_scales):
    c = x - means
    inv = torch.exp(-log_scales)
    plus, minus = _cdf(inv * (c + 1.0 / 255.0)), _cdf(inv * (c - 1.0 / 255.0))
    log_plus = torch.log(torch.clamp(plus, min=1e-12))
    log_1m_minus = torch.log(torch.clamp(1.0 - minus, min=1e-12))
    log_delta = torch.log(torch.clamp(plus - minus, min=1e-12))
    return torch.where(x < -0.999, log_plus, torch.where(x > 0.999, log_1m_minus, log_delta))


def hybrid_loss(sched: Schedule, model_fn, x_start, t, noise):
    """Per-example (loss, mse, vb) of an epsilon-predicting model with
    learned-range variance (rescaled MSE: the VLB with the mean frozen,
    times T/1000); ``model_fn(x_t, t_model)`` with t rescaled to 1000."""
    mean_flat = lambda v: v.mean(dim=tuple(range(1, v.ndim)))
    x_t = _at(sched.sqrt_acp, t) * x_start + _at(sched.sqrt_1m_acp, t) * noise
    out = model_fn(x_t, t.float() * (1000.0 / sched.num_timesteps)).float()
    eps, var_values = out.chunk(2, dim=-1)
    frac = (var_values + 1) / 2
    logvar = frac * _at(sched.log_betas, t) + (1 - frac) * _at(sched.post_logvar, t)
    x0 = _at(sched.sqrt_recip_acp, t) * x_t - _at(sched.sqrt_recipm1_acp, t) * eps.detach()
    mean = _at(sched.coef1, t) * x0 + _at(sched.coef2, t) * x_t
    true_mean = _at(sched.coef1, t) * x_start + _at(sched.coef2, t) * x_t
    kl = mean_flat(_normal_kl(true_mean, _at(sched.post_logvar, t), mean, logvar)) / math.log(2.0)
    nll = mean_flat(-_discretized_loglik(x_start, mean, 0.5 * logvar)) / math.log(2.0)
    vb = torch.where(t == 0, nll, kl) * (sched.num_timesteps / 1000.0)
    mse = mean_flat((noise - eps) ** 2)
    return mse + vb, mse, vb
