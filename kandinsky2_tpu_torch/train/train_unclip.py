"""Decoder (unCLIP 2.1 UNet) fine-tuning, the counterpart of
``kandinsky2_tpu/train/train_unclip.py`` (reference: kandinsky2/train_utils/
trainer_2_1_uclip.py:39-81) on one device.

* ``unclip_loss`` — the hybrid MSE + VLB loss of the UNet on a batch, for
  given timesteps and noise (``loss_fn`` inside the JAX train step).
* ``make_unclip_train_step`` — (``init_state``, ``train_step``): timestep
  sampling (uniform or loss-aware), q_sample, the UNet forward (under
  ``torch.utils.checkpoint`` with ``remat``), the loss and its backward
  (over ``accum_steps`` microbatches), the optimizer step, the EMA and the
  sampler update.  Where the JAX step returns a new state, this one updates
  the ``TrainState`` in place: the parameters, their gradients and the
  optimizer state are never held twice.
* ``train_unclip`` — the loop with its periodic whole-state save and its
  resume, then the inference weight export.

Freezing (train_utils/utils.py:212-229) is ``requires_grad_(False)`` on the
frozen parameters, and the optimizer holds only the trainable ones.  The
frozen encoders (MoVQ, XLM-R, CLIP ViT) run in the caller's
``prepare_batch``, ahead of the step (trainer_2_1_uclip.py:14-37).

A batch that holds ``inpaint_image`` and ``inpaint_mask`` trains the
inpainting UNet (``InpaintText2ImUNet21``) on them.

Not in this module yet: the spatial x data parallel and FSDP train
functions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs import schedule_kwargs
from ..diffusion.gaussian import LossType, MeanType, Schedule, VarType, make_schedule
from ..diffusion.gaussian import training_losses
from .checkpoint import (
    latest_train_state,
    restore_train_state,
    save_checkpoint,
    save_train_state,
)
from .ema import ema_update
from .optim import Adafactor, apply_freeze_mask, decoder_freeze_mask
from .resample import LossSecondMomentSampler, uniform_sample

DEFAULT_LR = 5e-6  # train_configs/config_unclip_2_1.yaml


def default_optimizer(params) -> torch.optim.Optimizer:
    """``optax.adafactor(learning_rate=5e-6)``, the YAML's optimizer."""
    return Adafactor(params, learning_rate=DEFAULT_LR)


@dataclasses.dataclass
class TrainState:
    """Everything a bitwise resume needs.  The parameters live in ``model``
    (the UNet here, the prior in ``train_prior``)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Optional[dict]
    generator: torch.Generator
    sampler: Optional[LossSecondMomentSampler] = None
    step: int = 0

    def state_dict(self) -> dict:
        return {
            "params": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "ema": self.ema_params,
            "sampler": None if self.sampler is None else self.sampler.state_dict(),
            "step": self.step,
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, saved: dict) -> None:
        """Restore in place; raise ValueError if the saved state was built
        with another model, optimizer, EMA or sampler structure."""
        have = self.state_dict()
        drift = [k for k in ("ema", "sampler") if (saved[k] is None) != (have[k] is None)]
        if set(saved["params"]) != set(have["params"]):
            drift.append("params")
        if [len(g["params"]) for g in saved["optimizer"]["param_groups"]] != [
                len(g["params"]) for g in have["optimizer"]["param_groups"]]:
            drift.append("optimizer")
        if drift:
            raise ValueError(f"the saved train state's {drift} do not match "
                             "this TrainState: the structure changed since it was saved")
        self.model.load_state_dict(saved["params"])
        self.optimizer.load_state_dict(saved["optimizer"])
        if self.ema_params is not None:
            with torch.no_grad():
                for name, e in self.ema_params.items():
                    e.copy_(saved["ema"][name])
        if self.sampler is not None:
            self.sampler.load_state_dict(saved["sampler"])
        self.step = int(saved["step"])
        self.generator.set_state(saved["generator"])


def unclip_loss(unet: nn.Module, sched: Schedule, batch: dict, t, noise, weights,
                *, mean_type: MeanType, var_type: VarType, loss_type: LossType,
                remat: bool = False):
    """(mean of the importance-weighted per-sample loss, per-sample terms)
    of the UNet on ``batch`` (image_latents [B, h, w, 4] NHWC, full_emb,
    pooled_emb, image_emb, and for the inpainting UNet inpaint_image and
    inpaint_mask) at timesteps ``t`` with ``noise``."""
    cond = (batch["full_emb"], batch["pooled_emb"], batch["image_emb"])
    inpaint = {k: batch[k] for k in ("inpaint_image", "inpaint_mask") if k in batch}

    def model_fn(x_t, t_model):
        if remat:
            return checkpoint(unet, x_t, t_model, *cond, use_reentrant=False, **inpaint)
        return unet(x_t, t_model, *cond, **inpaint)

    terms = training_losses(
        sched, model_fn, batch["image_latents"].float(), t, noise,
        mean_type=mean_type, var_type=var_type, loss_type=loss_type,
        channel_axis=-1,
    )
    return (terms["loss"] * weights).mean(), terms


def make_unclip_train_step(
    unet: nn.Module,
    diffusion_config: dict,
    optimizer_factory: Callable = default_optimizer,
    *,
    schedule_sampler: str = "uniform",
    ema_decay: Optional[float] = 0.9999,
    remat: bool = False,
    accum_steps: int = 1,
):
    """(init_state, train_step) for ``unet`` on the device its parameters
    lie on.

    ``init_state(trainable=None, seed=0)`` applies the freeze mask
    ({name: trainable}, all trainable by default), builds the optimizer over
    the trainable parameters with ``optimizer_factory``, the EMA shadow (a
    copy of every parameter), the sampler and the generator.

    ``train_step(state, batch, t=None, noise=None)`` runs one step in place
    and returns the metrics (mse, vb, loss) as 0-dim tensors.  ``t`` [B]
    and ``noise`` (the latents' shape) are drawn from ``state.generator``
    (t first) unless given.  ``accum_steps`` > 1 splits the batch into that
    many microbatches and accumulates their gradients: the update is the
    full batch's, while activation memory is one microbatch's.
    """
    skw = schedule_kwargs(diffusion_config, "")
    device = next(unet.parameters()).device
    sched = make_schedule(**skw["make_schedule"], device=device)
    loss_kw = dict(mean_type=skw["mean_type"], var_type=skw["var_type"],
                   loss_type=skw["loss_type"], remat=remat)
    if schedule_sampler not in ("uniform", "loss-second-moment"):
        raise ValueError(f"unknown schedule_sampler {schedule_sampler!r}")

    def init_state(trainable: Optional[dict] = None, seed: int = 0) -> TrainState:
        if trainable is None:
            trainable = {name: True for name, _ in unet.named_parameters()}
        params = apply_freeze_mask(unet, trainable)
        return TrainState(
            model=unet,
            optimizer=optimizer_factory(params),
            ema_params=(
                {n: p.detach().clone() for n, p in unet.named_parameters()}
                if ema_decay is not None else None
            ),
            generator=torch.Generator(device=device).manual_seed(seed),
            sampler=(LossSecondMomentSampler(sched.num_timesteps)
                     if schedule_sampler == "loss-second-moment" else None),
        )

    def train_step(state: TrainState, batch: dict, t=None, noise=None) -> dict:
        latents = batch["image_latents"]
        B = latents.shape[0]
        if B % accum_steps:
            raise ValueError(f"batch size {B} not divisible by accum_steps {accum_steps}")
        if t is None:
            if state.sampler is not None:
                t, weights = state.sampler.sample(state.generator, B)
            else:
                t, weights = uniform_sample(state.generator, sched.num_timesteps, B)
        else:
            t = torch.as_tensor(t, device=device).long()
            weights = (state.sampler.importance(t) if state.sampler is not None
                       else torch.ones((B,), device=device))
        if noise is None:
            noise = torch.randn(latents.shape, generator=state.generator,
                                device=device, dtype=torch.float32)
        noise = torch.as_tensor(noise, device=device).float()

        m = B // accum_steps
        loss = torch.zeros((), device=device)
        parts = []
        for i in range(accum_steps):
            sl = slice(i * m, (i + 1) * m)
            mb = {k: v[sl] for k, v in batch.items()}
            loss_m, terms_m = unclip_loss(unet, sched, mb, t[sl], noise[sl],
                                          weights[sl], **loss_kw)
            (loss_m / accum_steps).backward()
            loss += loss_m.detach() / accum_steps
            parts.append({k: v.detach() for k, v in terms_m.items()})
        terms = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        if state.ema_params is not None:
            ema_update(state.ema_params, dict(unet.named_parameters()), ema_decay,
                       num_updates=state.step)
        if state.sampler is not None:
            state.sampler.update(t, terms["loss"])
        state.step += 1
        metrics = {"mse": terms["mse"].mean() if "mse" in terms else loss}
        if "vb" in terms:
            metrics["vb"] = terms["vb"].mean()
        metrics["loss"] = loss
        return metrics

    return init_state, train_step


def fit(state: TrainState, train_step: Callable, loader, prepare_batch: Callable, *,
        num_epochs: int, save_every: int, save_path: str, log_every: int) -> TrainState:
    """The single-device loop of ``train_unclip`` and ``train_prior``: resume
    from the newest whole state under ``save_path``, run ``train_step`` on
    ``prepare_batch(raw)`` for every batch of ``num_epochs`` epochs, save the
    whole state every ``save_every`` steps and at the end, then export the
    model's weights for inference.  Given the same batches, a resumed run
    is bitwise identical to an uninterrupted one."""
    fname, _ = latest_train_state(save_path)
    if fname:
        restore_train_state(fname, state)
    for _ in range(num_epochs):
        for raw in loader:
            metrics = train_step(state, prepare_batch(raw))
            if state.step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"step {state.step}: {m}", flush=True)
            if state.step % save_every == 0:
                save_train_state(save_path, state)
    save_train_state(save_path, state)
    save_checkpoint(save_path, state.model.state_dict(), state.step)
    return state


def train_unclip(
    *,
    unet: nn.Module,
    diffusion_config: dict,
    loader,
    prepare_batch: Callable,
    optimizer_factory: Callable = default_optimizer,
    num_epochs: int = 1,
    save_every: int = 1000,
    save_path: str = "checkpoints/unclip",
    schedule_sampler: str = "uniform",
    freeze_resblocks: bool = False,
    freeze_attention: bool = False,
    ema_decay: Optional[float] = 0.9999,
    seed: int = 0,
    log_every: int = 50,
    remat: bool = False,
    accum_steps: int = 1,
) -> TrainState:
    """Single-device training loop (trainer_2_1_uclip.py:39-81).
    ``prepare_batch(raw)`` runs the frozen encoders and returns the step's
    batch; ``fit`` saves, resumes and exports."""
    init_state, train_step = make_unclip_train_step(
        unet, diffusion_config, optimizer_factory,
        schedule_sampler=schedule_sampler, ema_decay=ema_decay, remat=remat,
        accum_steps=accum_steps,
    )
    state = init_state(decoder_freeze_mask(unet, freeze_resblocks, freeze_attention),
                       seed)
    return fit(state, train_step, loader, prepare_batch, num_epochs=num_epochs,
               save_every=save_every, save_path=save_path, log_every=log_every)
