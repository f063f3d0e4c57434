"""What the 2.0, 2.1 and 2.2 pipelines share: the :class:`Pipeline` base
(the models under the names of the JAX pipeline's params, their seeded
random parameters, the weight bridge, the output images), the seeded
parameter draw :func:`init_random_`, and the decoder half of the 2.0 and
2.1 pipelines: classifier-free guidance over the CFG-doubled UNet
(:func:`cfg_mix`) and the five decoder samplers' tables and loops
(:func:`decoder_schedule`, :func:`sample_latents`), with the per-rank
noise stream of a row-sharded run (:func:`rank_generator`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..configs import schedule_kwargs
from ..diffusion import (
    ddim_loop,
    dpmpp_2m_loop,
    make_ddim_tables,
    make_dpmpp_karras_tables,
    make_dpmpp_tables,
    make_schedule,
    p_sample_loop,
    plms_loop,
)
from ..models.layers import Conv2d, GroupNorm32, LayerNormF32, Linear
from ..utils import process_images
from ..weights.from_jax import load_jax_params

SAMPLERS = ("p_sampler", "ddim_sampler", "plms_sampler", "dpmpp_sampler",
            "dpmpp_karras_sampler")

# last layers of residual branches: the reference initialises the UNet's to
# zero; drawn at a tenth of the usual scale they keep the random network
# well conditioned in bf16 without being zero
RESIDUAL_OUTPUTS = ("out_layers.3", "proj_out", "conv2")


def check_sampler(sampler: str) -> None:
    if sampler not in SAMPLERS:
        raise ValueError("Only " + ", ".join(SAMPLERS[:-1]) + " and "
                         + SAMPLERS[-1] + " are available")


def init_random_(module: nn.Module, generator: torch.Generator,
                 residual_outputs=RESIDUAL_OUTPUTS) -> None:
    """Draw every parameter from ``generator``: weights of linear layers and
    convolutions ~ N(0, 1/fan_in), a tenth of that for the residual
    branches' last layers (``residual_outputs``; the UNet's output conv is
    drawn in full, so its output is not identically zero), biases and
    embeddings ~ N(0, 0.02²), other free parameters ~ N(0, 0.01²) or
    N(0, 1/rows) for projection matrices; norms keep weight 1, bias 0."""

    def draw(p, std):
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) * std)

    for mod_name, mod in module.named_modules():
        if isinstance(mod, (GroupNorm32, LayerNormF32)):
            continue
        gain = 0.1 if mod_name.endswith(residual_outputs) else 1.0
        for name, p in mod.named_parameters(recurse=False):
            if name == "bias":
                draw(p, 0.02)
            elif isinstance(mod, nn.Embedding):
                draw(p, 0.02)
            elif isinstance(mod, (Linear, Conv2d)):
                draw(p, gain * p[0].numel() ** -0.5)
            elif name in ("text_projection", "proj"):
                draw(p, p.shape[0] ** -0.5)
            else:
                draw(p, 0.01)


class Pipeline:
    """Base of the pipelines.  A subclass sets ``device`` and ``dtype`` and
    lists its models in :meth:`models`."""

    residual_outputs = RESIDUAL_OUTPUTS
    # the seed of the pipeline's own generator until ``set_seed`` is called
    # (the JAX pipelines' default PRNGKey(0))
    _seed = 0
    _generator: Optional[torch.Generator] = None

    def models(self) -> dict:
        """The models under the names of the JAX pipeline's params."""
        raise NotImplementedError

    def _draw_extra_(self, generator: torch.Generator) -> None:
        """Parameters that :func:`init_random_` does not draw, after it."""

    def init_random_params(self, generator: Optional[torch.Generator] = None,
                           dtype=None):
        """Random parameters from ``generator`` (seed 0 by default), then cast
        to ``dtype`` (the activation dtype by default).  ``torch.float32``
        keeps fp32 parameters while every module still computes in the
        pipeline's dtype: the JAX trainer's policy (fp32 parameters, bf16
        compute)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        for model in self.models().values():
            init_random_(model, generator, self.residual_outputs)
        self._draw_extra_(generator)
        self.cast_models_(dtype)

    def cast_models_(self, dtype=None):
        """Every model's parameters and buffers cast to ``dtype`` (the
        activation dtype by default), in place."""
        for model in self.models().values():
            model.to(dtype or self.dtype)
        return self

    def set_seed(self, seed: int) -> None:
        """Reset the pipeline's own generator, which the entry points draw
        from when given no ``generator``."""
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

    def _gen(self, generator: Optional[torch.Generator]) -> torch.Generator:
        """``generator``, or the pipeline's own (seeded with ``_seed`` at
        first use): never torch's global generator."""
        if generator is not None:
            return generator
        if self._generator is None:
            self.set_seed(self._seed)
        return self._generator

    def load_jax_params(self, params: dict):
        """Load the JAX pipeline's params (one nested dict of arrays per
        model) through the bridge, keeping each parameter's device and
        dtype."""
        for name, model in self.models().items():
            load_jax_params(model, params[name])

    @staticmethod
    def _output(images: torch.Tensor, output: str, h: Optional[int] = None,
                w: Optional[int] = None):
        """The float NHWC images (``output="float"``) or PIL images, cropped
        to ``h`` x ``w`` where given."""
        images = images[:, :h, :w, :].cpu().numpy()
        return images if output == "float" else process_images(images)


def cfg_mix(out: torch.Tensor, batch: int, channels: int, guidance_scale: float,
            with_variance: bool) -> torch.Tensor:
    """Classifier-free guidance over the UNet's output on a [cond; uncond]
    batch: uncond + s (cond - uncond) of the first ``channels`` (eps), and
    for the p_sampler (``with_variance``) the cond half's learned-variance
    channels after them."""
    eps, rest = out[..., :channels], out[..., channels:]
    cond_eps, uncond_eps = eps[:batch], eps[batch:]
    eps_g = uncond_eps + guidance_scale * (cond_eps - uncond_eps)
    return torch.cat([eps_g, rest[:batch]], dim=-1) if with_variance else eps_g


def decoder_schedule(diff_cfg: dict, sampler: str, num_steps: int, device=None):
    """(schedule kwargs, schedule) of a decoder sampler: the p_sampler walks
    the schedule respaced to ``num_steps``, the others a ladder over the
    base schedule."""
    dkw = schedule_kwargs(diff_cfg, str(num_steps) if sampler == "p_sampler" else "")
    return dkw, make_schedule(**dkw["make_schedule"], device=device)


def rank_generator(generator: torch.Generator, axis) -> torch.Generator:
    """This rank's own noise stream on row shards (``fold_in`` of the JAX
    pipeline's key with the axis index): a generator seeded from a draw of
    the shared ``generator``, the same draw on every rank, and the rank."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(
        (seed * 65537 + axis.index) % 2**63)


def sample_latents(model_fn: Callable, x_T: torch.Tensor, *, sampler: str,
                   diff_cfg: dict, num_steps: int, init_step: Optional[int],
                   generator: Optional[torch.Generator], eta: float = 0.0,
                   denoised_fn: Optional[Callable] = None, model_state=None,
                   noise_seq: Optional[torch.Tensor] = None,
                   sp_axis=None) -> torch.Tensor:
    """The decoder sampler's loop from ``x_T`` (the JAX pipelines' latent
    program after the conditioning): ``p_sampler`` (x0 clipped, then
    ``denoised_fn``; ``model_fn`` returns eps and the variance channels),
    DDIM (``eta`` > 0 draws from ``noise_seq`` or ``generator``), PLMS,
    DPM++ 2M on the uniform or the Karras grid.  ``init_step`` starts a
    truncated ladder: in respaced units for the p_sampler, 1000-step units
    otherwise.  ``model_state`` is the turbo deep cache, threaded through
    ``model_fn``.  ``sp_axis``: x_T, ``noise_seq`` and the model's
    activations are this rank's row shard, and the p_sampler's dynamic
    threshold spans the whole image."""
    dev = x_T.device
    dkw, sched = decoder_schedule(diff_cfg, sampler, num_steps, dev)
    if sampler == "p_sampler":
        return p_sample_loop(
            model_fn, sched, x_T, generator, mean_type=dkw["mean_type"],
            var_type=dkw["var_type"], clip_denoised=True, denoised_fn=denoised_fn,
            init_step=init_step, channel_axis=-1, model_state=model_state,
            noise_seq=noise_seq, threshold_axis=sp_axis)
    base = sched.base_alphas_cumprod
    if sampler == "ddim_sampler":
        tables = make_ddim_tables(base, num_steps, eta=eta, init_step=init_step,
                                  device=dev)
        return ddim_loop(model_fn, tables, x_T, generator, eta=eta,
                         noise_seq=noise_seq, model_state=model_state)
    if sampler == "plms_sampler":
        tables = make_ddim_tables(base, num_steps, init_step=init_step, device=dev)
        return plms_loop(model_fn, tables, x_T, model_state=model_state)
    make = make_dpmpp_tables if sampler == "dpmpp_sampler" else make_dpmpp_karras_tables
    return dpmpp_2m_loop(model_fn, make(base, num_steps, init_step=init_step,
                                        device=dev), x_T, model_state=model_state)
