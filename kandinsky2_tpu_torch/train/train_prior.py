"""Diffusion-prior training, the counterpart of
``kandinsky2_tpu/train/train_prior.py`` (reference: kandinsky2/train_utils/
trainer_prior.py:29-70), on one device or, with ``data_axis``, data-parallel
over ranks.

The prior predicts x0, the clip_mean/std-normalised CLIP image embedding,
from CLIP text features (cosine schedule, MSE loss; configs.py:113-123).
The step and its state are the decoder trainer's: ``TrainState`` of
``train_unclip`` (parameters in ``model``, optimizer, EMA shadow,
generator, step), updated in place, and its loop ``fit``.  The prior's
attention is masked, so it runs plain PyTorch and launches no kernel.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..configs import schedule_kwargs
from ..diffusion.gaussian import make_schedule, training_losses
from .ema import ema_update
from .resample import uniform_sample
from ..parallel.collectives import pmean, pmean_grads
from .train_unclip import TrainState, _shard_generators, default_optimizer, fit


def make_prior_train_step(prior: nn.Module, diffusion_config: dict,
                          optimizer_factory: Callable = default_optimizer, *,
                          ema_decay: float = 0.9999, data_axis=None):
    """(init_state, train_step) for ``prior`` on the device its parameters
    lie on.

    ``init_state(seed=0)`` builds the optimizer over every parameter, the
    EMA shadow and the generator.  ``train_step(state, batch, t=None,
    noise=None)`` runs one step in place on batch = {image_emb [B, D] (the
    normalised x0 target), txt_feat [B, D], txt_feat_seq [B, ctx, W],
    mask [B, ctx]} and returns {"loss"}; t [B] is drawn uniformly and then
    the noise, from ``state.generator``, unless given.

    ``data_axis`` (a ``parallel.mesh.MeshAxis``): the batch is this rank's
    examples, the gradients and the loss are ``pmean``'d over the axis
    (``kandinsky2_tpu/train/train_prior.py:79-81``), and undrawn t and
    noise come from a generator of this data shard's own, seeded from one
    draw of ``state.generator`` (``train_unclip._shard_generators``)."""
    skw = schedule_kwargs(diffusion_config, "")
    device = next(prior.parameters()).device
    sched = make_schedule(**skw["make_schedule"], device=device)
    loss_kw = dict(mean_type=skw["mean_type"], var_type=skw["var_type"],
                   loss_type=skw["loss_type"], channel_axis=-1)

    def init_state(seed: int = 0) -> TrainState:
        return TrainState(
            model=prior, optimizer=optimizer_factory(list(prior.parameters())),
            ema_params={n: p.detach().clone() for n, p in prior.named_parameters()},
            generator=torch.Generator(device=device).manual_seed(seed))

    def train_step(state: TrainState, batch: dict, t=None, noise=None) -> dict:
        x0 = batch["image_emb"].float()
        B = x0.shape[0]
        gen = state.generator
        if data_axis is not None and (t is None or noise is None):
            gen = _shard_generators(state.generator, data_axis, None)[0]
        if t is None:
            t, weights = uniform_sample(gen, sched.num_timesteps, B)
        else:
            t = torch.as_tensor(t, device=device).long()
            weights = torch.ones((B,), device=device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=gen, device=device)
        noise = torch.as_tensor(noise, device=device).float()

        def model_fn(x_t, t_model):
            return prior(x_t, t_model, text_emb=batch["txt_feat"],
                         text_enc=batch["txt_feat_seq"], mask=batch["mask"])

        terms = training_losses(sched, model_fn, x0, t, noise, **loss_kw)
        loss = (terms["loss"] * weights).mean()
        loss.backward()
        if data_axis is not None:
            pmean_grads([p for p in prior.parameters() if p.requires_grad], data_axis)
            loss = pmean(loss.detach(), data_axis)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        ema_update(state.ema_params, dict(prior.named_parameters()), ema_decay,
                   num_updates=state.step)
        state.step += 1
        return {"loss": loss.detach()}

    return init_state, train_step


def train_prior(*, prior: nn.Module, diffusion_config: dict, loader,
                prepare_batch: Callable, optimizer_factory: Callable = default_optimizer,
                num_epochs: int = 1, save_every: int = 1000,
                save_path: str = "checkpoints/prior", ema_decay: float = 0.9999,
                seed: int = 0, log_every: int = 50) -> TrainState:
    """Single-device loop (trainer_prior.py:29-70) with the whole-state save
    and resume and the inference export of ``fit``."""
    init_state, train_step = make_prior_train_step(
        prior, diffusion_config, optimizer_factory, ema_decay=ema_decay)
    return fit(init_state(seed), train_step, loader, prepare_batch,
               num_epochs=num_epochs, save_every=save_every, save_path=save_path,
               log_every=log_every)
