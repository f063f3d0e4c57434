"""Gaussian diffusion math on tensors: the counterpart of
``kandinsky2_tpu/diffusion/gaussian.py``: sampling with the dynamic
threshold, the hybrid MSE + VLB training loss, and the bits-per-dim
evaluation (``prior_bpd``, ``calc_bpd_loop``).

Tables are built in float64 numpy (``schedules.py``) and stored as float32
tensors on the caller's device, as the JAX package stores them.
"""

from __future__ import annotations

import dataclasses
import enum
import math
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


class LossType(enum.Enum):
    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"


@dataclasses.dataclass
class Schedule:
    """Per-timestep constants of a (possibly respaced) process, float32
    tensors of shape [num_timesteps]."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    log_betas: torch.Tensor
    fixed_large_variance: torch.Tensor
    log_fixed_large_variance: torch.Tensor
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
    fixed_large = np.append(posterior_variance[1], betas[1:])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Schedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
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
        log_betas=f32(np.log(betas)),
        fixed_large_variance=f32(fixed_large),
        log_fixed_large_variance=f32(np.log(fixed_large)),
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


def predict_xstart_from_xprev(sched: Schedule, x_t, t, xprev):
    nd = x_t.ndim
    return (
        extract(1.0 / sched.posterior_mean_coef1, t, nd) * xprev
        - extract(sched.posterior_mean_coef2 / sched.posterior_mean_coef1, t, nd) * x_t
    )


def predict_eps_from_xstart(sched: Schedule, x_t, t, pred_xstart):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart
    ) / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd)


def dynamic_threshold(x: torch.Tensor, percentile: float = 99.5) -> torch.Tensor:
    """The dynamic threshold of gaussian_diffusion.py:284-294: the
    ``percentile`` of |x[0]| (linear interpolation, as ``jnp.percentile``),
    at least 1, clips and rescales the whole batch; one scalar from batch
    element 0, as the reference takes it."""
    v = x[0].abs().float().flatten()
    s = torch.clamp(torch.quantile(v, percentile / 100.0), min=1.0)
    return torch.maximum(torch.minimum(x, s), -s) / s


def process_xstart(x: torch.Tensor, clip_denoised: bool,
                   denoised_fn: Optional[Callable] = None) -> torch.Tensor:
    """``denoised_fn``, then the dynamic threshold where ``clip_denoised``,
    in the reference's order (gaussian_diffusion.py:284-294)."""
    if denoised_fn is not None:
        x = denoised_fn(x)
    if clip_denoised:
        x = dynamic_threshold(x)
    return x


def q_sample(sched: Schedule, x_start, t, noise):
    """Sample q(x_t | x_0) (gaussian_diffusion.py:183-199)."""
    nd = x_start.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
        + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise
    )


def q_mean_variance(sched: Schedule, x_start, t):
    nd = x_start.ndim
    mean = extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
    variance = extract(1.0 - sched.alphas_cumprod, t, nd)
    log_variance = extract(sched.log_one_minus_alphas_cumprod, t, nd)
    return mean, variance, log_variance


def q_posterior_mean(sched: Schedule, x_start, x_t, t):
    """Mean of q(x_{t-1} | x_t, x_0) (gaussian_diffusion.py:201-221)."""
    nd = x_t.ndim
    return (
        extract(sched.posterior_mean_coef1, t, nd) * x_start
        + extract(sched.posterior_mean_coef2, t, nd) * x_t
    )


def q_posterior_mean_variance(sched: Schedule, x_start, x_t, t):
    """q(x_{t-1} | x_t, x_0) (gaussian_diffusion.py:201-221): mean,
    variance, clipped log variance."""
    nd = x_t.ndim
    return (
        q_posterior_mean(sched, x_start, x_t, t),
        extract(sched.posterior_variance, t, nd),
        extract(sched.posterior_log_variance_clipped, t, nd),
    )


def p_mean_variance(
    sched: Schedule,
    model_output: torch.Tensor,
    x: torch.Tensor,
    t: torch.Tensor,
    *,
    mean_type: MeanType,
    var_type: VarType,
    clip_denoised: bool = True,
    denoised_fn: Optional[Callable] = None,
    channel_axis: int = 1,
):
    """p(x_{t-1} | x_t) from a model output (gaussian_diffusion.py:223-322).
    ``channel_axis`` says where the learned-variance channels live: 1 for
    NCHW, -1 for NHWC latents.  The x0 prediction goes through
    ``process_xstart`` (``denoised_fn``, then the dynamic threshold where
    ``clip_denoised``).

    Returns dict(mean, variance, log_variance, pred_xstart)."""
    nd = x.ndim
    if var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
        model_output, var_values = torch.chunk(model_output, 2, dim=channel_axis)
        if var_type == VarType.LEARNED:
            log_variance = var_values
        else:
            min_log = extract(sched.posterior_log_variance_clipped, t, nd)
            max_log = extract(sched.log_betas, t, nd)
            frac = (var_values + 1) / 2
            log_variance = frac * max_log + (1 - frac) * min_log
        variance = torch.exp(log_variance)
    elif var_type == VarType.FIXED_LARGE:
        variance = extract(sched.fixed_large_variance, t, nd).expand(x.shape)
        log_variance = extract(sched.log_fixed_large_variance, t, nd).expand(x.shape)
    elif var_type == VarType.FIXED_SMALL:
        variance = extract(sched.posterior_variance, t, nd).expand(x.shape)
        log_variance = extract(sched.posterior_log_variance_clipped, t, nd).expand(
            x.shape
        )
    else:
        raise NotImplementedError(var_type)
    if mean_type == MeanType.PREVIOUS_X:
        pred_xstart = process_xstart(
            predict_xstart_from_xprev(sched, x, t, model_output), clip_denoised,
            denoised_fn)
        mean = model_output
    elif mean_type in (MeanType.START_X, MeanType.EPSILON):
        if mean_type == MeanType.EPSILON:
            model_output = predict_xstart_from_eps(sched, x, t, model_output)
        pred_xstart = process_xstart(model_output, clip_denoised, denoised_fn)
        mean = q_posterior_mean(sched, pred_xstart, x, t)
    else:
        raise NotImplementedError(mean_type)
    return {"mean": mean, "variance": variance, "log_variance": log_variance,
            "pred_xstart": pred_xstart}


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two Gaussians (losses.py:12-39)."""
    return 0.5 * (
        -1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * torch.pow(x, 3))))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a discretized Gaussian on [-1, 1] images
    (losses.py:49-75)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(
        x < -0.999, log_cdf_plus,
        torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta),
    )


def mean_flat(x):
    return x.mean(dim=tuple(range(1, x.ndim)))


def vb_terms_bpd(sched: Schedule, model_output, x_start, x_t, t, *,
                 mean_type: MeanType, var_type: VarType, channel_axis: int = 1):
    """Per-sample variational-bound term in bits (gaussian_diffusion.py:
    637-668): KL(q(x_{t-1}|x_t,x_0) || p(x_{t-1}|x_t)), the decoder NLL at
    t = 0.  Returns (vb [B], pred_xstart)."""
    true_mean, _, true_logvar = q_posterior_mean_variance(sched, x_start, x_t, t)
    out = p_mean_variance(sched, model_output, x_t, t, mean_type=mean_type,
                          var_type=var_type, clip_denoised=False,
                          channel_axis=channel_axis)
    kl = mean_flat(normal_kl(true_mean, true_logvar, out["mean"],
                             out["log_variance"])) / math.log(2.0)
    decoder_nll = mean_flat(-discretized_gaussian_log_likelihood(
        x_start, means=out["mean"], log_scales=0.5 * out["log_variance"]
    )) / math.log(2.0)
    return torch.where(t == 0, decoder_nll, kl), out["pred_xstart"]


def prior_bpd(sched: Schedule, x_start):
    """The prior KL term of the VLB in bits per dimension
    (gaussian_diffusion.py:744-758): KL(q(x_T | x_0) || N(0, I))."""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1, dtype=torch.long,
                   device=x_start.device)
    qt_mean, _, qt_logvar = q_mean_variance(sched, x_start, t)
    zero = torch.zeros((), device=x_start.device)
    return mean_flat(normal_kl(qt_mean, qt_logvar, zero, zero)) / math.log(2.0)


def calc_bpd_loop(sched: Schedule, model_fn: Callable, x_start,
                  generator: Optional[torch.Generator] = None, *, noise=None,
                  mean_type: MeanType = MeanType.EPSILON,
                  var_type: VarType = VarType.LEARNED_RANGE,
                  channel_axis: int = -1) -> dict:
    """The whole VLB (gaussian_diffusion.py:760-813), one model call per
    timestep from T − 1 down to 0.  The noise of timestep t is ``noise[t]``
    ([T, *x_start.shape]) where given, else drawn from ``generator`` in
    that order.  Returns dict(total_bpd [B], prior_bpd [B], and vb,
    xstart_mse, mse [B, T] with column j for timestep T − 1 − j)."""
    B = x_start.shape[0]
    vb, xstart_mse, mse = [], [], []
    for t_scalar in range(sched.num_timesteps - 1, -1, -1):
        t = torch.full((B,), t_scalar, dtype=torch.long, device=x_start.device)
        eps = (torch.as_tensor(noise[t_scalar], device=x_start.device).float()
               if noise is not None else
               torch.randn(x_start.shape, generator=generator, device=x_start.device))
        x_t = q_sample(sched, x_start, t, eps)
        model_output = model_fn(x_t, sched.model_timesteps(t)).float()
        v, pred_xstart = vb_terms_bpd(sched, model_output, x_start, x_t, t,
                                      mean_type=mean_type, var_type=var_type,
                                      channel_axis=channel_axis)
        vb.append(v)
        xstart_mse.append(mean_flat((pred_xstart - x_start) ** 2))
        pred_eps = predict_eps_from_xstart(sched, x_t, t, pred_xstart)
        mse.append(mean_flat((pred_eps - eps) ** 2))
    vb, xstart_mse, mse = (torch.stack(v, dim=1) for v in (vb, xstart_mse, mse))
    pb = prior_bpd(sched, x_start)
    return {"total_bpd": vb.sum(dim=1) + pb, "prior_bpd": pb, "vb": vb,
            "xstart_mse": xstart_mse, "mse": mse}


def training_losses(sched: Schedule, model_fn: Callable, x_start, t, noise, *,
                    mean_type: MeanType = MeanType.EPSILON,
                    var_type: VarType = VarType.LEARNED_RANGE,
                    loss_type: LossType = LossType.RESCALED_MSE,
                    channel_axis: int = -1):
    """Hybrid MSE + (frozen-mean) VLB training loss (gaussian_diffusion.py:
    670-742).  ``model_fn(x_t, t_model)`` applies the network; returns
    dict(loss, mse, vb) of per-sample [B] terms (``loss`` alone for the KL
    losses)."""
    x_t = q_sample(sched, x_start, t, noise)
    model_output = model_fn(x_t, sched.model_timesteps(t)).float()
    terms = {}
    if loss_type in (LossType.KL, LossType.RESCALED_KL):
        vb, _ = vb_terms_bpd(sched, model_output, x_start, x_t, t,
                             mean_type=mean_type, var_type=var_type,
                             channel_axis=channel_axis)
        if loss_type == LossType.RESCALED_KL:
            vb = vb * sched.num_timesteps
        terms["loss"] = vb
        return terms
    if var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
        mean_part, var_part = torch.chunk(model_output, 2, dim=channel_axis)
        # learn the variance with the VLB, without moving the mean
        frozen = torch.cat([mean_part.detach(), var_part], dim=channel_axis)
        vb, _ = vb_terms_bpd(sched, frozen, x_start, x_t, t, mean_type=mean_type,
                             var_type=var_type, channel_axis=channel_axis)
        if loss_type == LossType.RESCALED_MSE:
            vb = vb * (sched.num_timesteps / 1000.0)
        terms["vb"] = vb
        model_output = mean_part
    if mean_type == MeanType.EPSILON:
        target = noise
    elif mean_type == MeanType.START_X:
        target = x_start
    else:
        target = q_posterior_mean(sched, x_start, x_t, t)
    terms["mse"] = mean_flat((target - model_output) ** 2)
    terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
    return terms
