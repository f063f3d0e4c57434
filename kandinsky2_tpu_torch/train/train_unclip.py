"""Decoder (unCLIP 2.1 UNet) fine-tuning, the counterpart of
``kandinsky2_tpu/train/train_unclip.py`` (reference: kandinsky2/train_utils/
trainer_2_1_uclip.py:39-81), on one device or over a mesh of ranks.

* ``unclip_loss`` — the hybrid MSE + VLB loss of the UNet on a batch, for
  given timesteps and noise (``loss_fn`` inside the JAX train step).
* ``make_unclip_train_step`` — (``init_state``, ``train_step``): timestep
  sampling (uniform or loss-aware), q_sample, the UNet forward (under
  ``torch.utils.checkpoint`` with ``remat``), the loss and its backward
  (over ``accum_steps`` microbatches), the optimizer step, the EMA and the
  sampler update.  Where the JAX step returns a new state, this one updates
  the ``TrainState`` in place: the parameters, their gradients and the
  optimizer state are never held twice.
* ``make_spdp_train_fn`` — the same step over a ``(data, sp)`` mesh of
  ranks: examples sharded over ``data``, latent rows over ``sp`` (the
  row-sharded UNet of ``parallel/spatial.py``), parameters, optimizer and
  EMA replicated.
* ``train_unclip`` — the loop with its periodic whole-state save and its
  resume, then the inference weight export; ``mesh_shape=(d, s)`` runs it
  on every rank of a ``d·s``-rank group through ``make_spdp_train_fn``.

Freezing (train_utils/utils.py:212-229) is ``requires_grad_(False)`` on the
frozen parameters, and the optimizer holds only the trainable ones.  The
frozen encoders (MoVQ, XLM-R, CLIP ViT) run in the caller's
``prepare_batch``, ahead of the step (trainer_2_1_uclip.py:14-37).

A batch that holds ``inpaint_image`` and ``inpaint_mask`` trains the
inpainting UNet (``InpaintText2ImUNet21``) on them.

Sharded steps follow the JAX step's convention inside
``shard_map(check_vma=False)``: every rank seeds its own copy of the loss
(the per-example terms ``pmean``'d over ``sp``), the collectives' backwards
are their transposes (``parallel/collectives.py``), and the gradients are
``pmean``'d over ``sp`` and then over ``data``: the result is the
unsharded gradient of the whole batch, bitwise the same on every rank, so
the replicated optimizer and EMA stay bitwise equal.  Not in this module
yet: the FSDP train function (``make_fsdp_train_fn``).
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
from ..parallel import spatial as _sp
from ..parallel.collectives import pmean, pmean_grads
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
                remat: bool = False, sp_axis=None):
    """(mean of the importance-weighted per-sample loss, per-sample terms)
    of the UNet on ``batch`` (image_latents [B, h, w, 4] NHWC, full_emb,
    pooled_emb, image_emb, and for the inpainting UNet inpaint_image and
    inpaint_mask) at timesteps ``t`` with ``noise``.  With ``sp_axis`` the
    latents (and the inpainting inputs) are this rank's rows, the UNet runs
    row-sharded (its ``sp_axis`` set by the caller), and the per-sample
    terms, means over the local rows, are ``pmean``'d over the axis: equal
    shards make that the mean over the whole image."""
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
    if sp_axis is not None:
        terms = {k: pmean(v, sp_axis) for k, v in terms.items()}
    return (terms["loss"] * weights).mean(), terms


def _shard_generators(generator: torch.Generator, data_axis, sp_axis):
    """The (timestep, noise) generators of a sharded step: seeded from one
    draw of the shared ``generator`` (the same draw on every rank, so the
    state stays replicated) with the data index, which gives each data
    shard its own timesteps and one t an example across its ``sp`` group,
    and for the noise the sp index too, so each row shard draws its own
    rows (JAX folds the indices into its keys, ``train_unclip.py:141-148``)."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
    d = 0 if data_axis is None else data_axis.index
    s = 0 if sp_axis is None else sp_axis.index
    make = lambda k: torch.Generator(device=generator.device).manual_seed(k % 2**63)
    base = seed * 65537 + d * 8191
    return make(base), make(base * 8191 + s + 1)


def make_unclip_train_step(
    unet: nn.Module,
    diffusion_config: dict,
    optimizer_factory: Callable = default_optimizer,
    *,
    schedule_sampler: str = "uniform",
    ema_decay: Optional[float] = 0.9999,
    remat: bool = False,
    accum_steps: int = 1,
    data_axis=None,
    sp_axis=None,
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

    ``data_axis`` / ``sp_axis`` (``parallel.mesh.MeshAxis``; see
    ``make_spdp_train_fn``): the batch, ``t`` and ``noise`` are this rank's
    shard (its examples, and with ``sp_axis`` its latent rows); undrawn
    ``t`` and ``noise`` come from ``_shard_generators``.  The UNet runs
    row-sharded over ``sp_axis`` for the step (``using_sp_axis``, also
    around the backward, where ``remat`` recomputes the forward); the
    gradients are ``pmean``'d over ``sp_axis``, then ``data_axis``, the
    loss and metrics over ``data_axis``, and the sampler takes every data
    shard's (t, loss) pairs.
    """
    skw = schedule_kwargs(diffusion_config, "")
    device = next(unet.parameters()).device
    sched = make_schedule(**skw["make_schedule"], device=device)
    loss_kw = dict(mean_type=skw["mean_type"], var_type=skw["var_type"],
                   loss_type=skw["loss_type"], remat=remat, sp_axis=sp_axis)
    sharded = data_axis is not None or sp_axis is not None
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
        gen_t = gen_n = state.generator
        if sharded and (t is None or noise is None):
            gen_t, gen_n = _shard_generators(state.generator, data_axis, sp_axis)
        if t is None:
            if state.sampler is not None:
                t, weights = state.sampler.sample(gen_t, B)
            else:
                t, weights = uniform_sample(gen_t, sched.num_timesteps, B)
        else:
            t = torch.as_tensor(t, device=device).long()
            weights = (state.sampler.importance(t) if state.sampler is not None
                       else torch.ones((B,), device=device))
        if noise is None:
            noise = torch.randn(latents.shape, generator=gen_n,
                                device=device, dtype=torch.float32)
        noise = torch.as_tensor(noise, device=device).float()

        m = B // accum_steps
        loss = torch.zeros((), device=device)
        parts = []
        with _sp.using_sp_axis(unet, sp_axis):
            for i in range(accum_steps):
                sl = slice(i * m, (i + 1) * m)
                mb = {k: v[sl] for k, v in batch.items()}
                loss_m, terms_m = unclip_loss(unet, sched, mb, t[sl], noise[sl],
                                              weights[sl], **loss_kw)
                (loss_m / accum_steps).backward()
                loss += loss_m.detach() / accum_steps
                parts.append({k: v.detach() for k, v in terms_m.items()})
        terms = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        trainable = [p for p in unet.parameters() if p.requires_grad]
        for axis in (sp_axis, data_axis):
            if axis is not None:
                pmean_grads(trainable, axis)

        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        if state.ema_params is not None:
            ema_update(state.ema_params, dict(unet.named_parameters()), ema_decay,
                       num_updates=state.step)
        if state.sampler is not None:
            state.sampler.update(t, terms["loss"], axis=data_axis)
        state.step += 1
        metrics = {"mse": terms["mse"].mean() if "mse" in terms else loss}
        if "vb" in terms:
            metrics["vb"] = terms["vb"].mean()
        metrics["loss"] = loss
        if data_axis is not None:
            metrics = {k: pmean(v, data_axis) for k, v in metrics.items()}
        return metrics

    return init_state, train_step


def make_spdp_train_fn(
    unet: nn.Module,
    diffusion_config: dict,
    optimizer_factory: Callable,
    mesh,
    *,
    data_axis: Optional[str] = "data",
    sp_axis: str = "sp",
    **step_kwargs,
):
    """(init_state, train_fn): the train step over a ``(data, sp)``
    ``parallel.mesh.Mesh`` of ranks, examples sharded over ``data_axis``,
    latent ROWS over ``sp_axis``, parameters, optimizer and EMA replicated
    (``kandinsky2_tpu/train/train_unclip.py:279-329``).  Row sharding
    divides the UNet's activation memory by the sp size.  ``data_axis``
    None: an sp-only mesh.

    ``init_state`` is ``make_unclip_train_step``'s.  ``train_fn(state,
    batch, t=None, noise=None, sharded=False)`` runs one step on every rank:
    ``batch`` (and ``t`` [B], ``noise`` shaped like the latents) is the
    whole batch, the same on every rank, unless ``sharded``, where it is
    this rank's shard already.  A 4-D tensor is sharded over (data, sp)
    (its examples, then its rows), anything else over data (JAX's specs,
    ``:312-317``).  The global batch must divide by the data size and the
    latent rows by ``sp * 2^(levels-1)``.  Every rank calls it with the same
    arguments."""
    sp = mesh.axis(sp_axis)
    data = None if data_axis is None else mesh.axis(data_axis)
    init_state, train_step = make_unclip_train_step(
        unet, diffusion_config, optimizer_factory, data_axis=data, sp_axis=sp,
        **step_kwargs)
    levels = len(unet.channel_mult)

    def shard(v: torch.Tensor, rows: bool) -> torch.Tensor:
        if data is not None:
            if v.shape[0] % data.size:
                raise ValueError(f"batch size {v.shape[0]} not divisible by the "
                                 f"data axis size {data.size}")
            b = v.shape[0] // data.size
            v = v.narrow(0, data.index * b, b)
        return _sp.shard_rows(v, sp) if rows else v

    def train_fn(state: TrainState, batch: dict, t=None, noise=None,
                 sharded: bool = False) -> dict:
        if not sharded:
            _sp.check_sp_rows(batch["image_latents"].shape[1], sp.size, levels)
            batch = {k: shard(v, v.dim() == 4) for k, v in batch.items()}
            t = None if t is None else shard(torch.as_tensor(t), False)
            noise = None if noise is None else shard(torch.as_tensor(noise), True)
        return train_step(state, batch, t, noise)

    return init_state, train_fn


def fit(state: TrainState, train_step: Callable, loader, prepare_batch: Callable, *,
        num_epochs: int, save_every: int, save_path: str, log_every: int,
        writer: bool = True) -> TrainState:
    """The loop of ``train_unclip`` and ``train_prior``: resume from the
    newest whole state under ``save_path``, run ``train_step`` on
    ``prepare_batch(raw)`` for every batch of ``num_epochs`` epochs, save the
    whole state every ``save_every`` steps and at the end, then export the
    model's weights for inference.  Given the same batches, a resumed run
    is bitwise identical to an uninterrupted one.  On a mesh every rank
    runs it and resumes; only the ``writer`` (rank 0) logs and saves."""
    fname, _ = latest_train_state(save_path)
    if fname:
        restore_train_state(fname, state)
    for _ in range(num_epochs):
        for raw in loader:
            metrics = train_step(state, prepare_batch(raw))
            if writer and state.step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"step {state.step}: {m}", flush=True)
            if writer and state.step % save_every == 0:
                save_train_state(save_path, state)
    if writer:
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
    mesh_shape: Optional[tuple] = None,
    fsdp: Optional[int] = None,
) -> TrainState:
    """Training loop (trainer_2_1_uclip.py:39-81).  ``prepare_batch(raw)``
    runs the frozen encoders and returns the step's batch; ``fit`` saves,
    resumes and exports.

    ``mesh_shape=(data, sp)``: every rank of a ``torch.distributed`` group
    of data·sp ranks calls this with the same arguments and the same
    loader, and the step is ``make_spdp_train_fn``'s over that mesh (batch
    divisible by ``data``, latent rows by ``sp * 2^(levels-1)``; either may
    be 1); rank 0 logs and writes the checkpoints, and a resume restores
    every rank.  ``fsdp`` (the ZeRO-sharded state) is not ported."""
    if fsdp is not None and mesh_shape is not None:
        raise ValueError("fsdp and mesh_shape (spatial x data) are separate paths; "
                         "pick one")
    if fsdp is not None:
        raise NotImplementedError(
            "fsdp: the ZeRO-sharded train state (make_fsdp_train_fn) is not ported "
            "to PyTorch yet (ROADMAP.md Queue 1 item 4, part 3); use "
            "parallel: {data: D, sp: S}")
    kw = dict(schedule_sampler=schedule_sampler, ema_decay=ema_decay, remat=remat,
              accum_steps=accum_steps)
    writer = True
    if mesh_shape is not None:
        import torch.distributed as dist

        from ..parallel.mesh import Mesh

        d, s = (int(v) for v in mesh_shape)
        if not dist.is_initialized() or dist.get_world_size() != d * s:
            raise ValueError(f"mesh_shape {tuple(mesh_shape)} needs a torch.distributed "
                             f"group of {d * s} ranks (parallel.launch)")
        mesh = Mesh(None, ("data", "sp"), shape=(d, s))
        init_state, train_step = make_spdp_train_fn(
            unet, diffusion_config, optimizer_factory, mesh, **kw)
        writer = dist.get_rank() == 0
    else:
        init_state, train_step = make_unclip_train_step(
            unet, diffusion_config, optimizer_factory, **kw)
    state = init_state(decoder_freeze_mask(unet, freeze_resblocks, freeze_attention),
                       seed)
    return fit(state, train_step, loader, prepare_batch, num_epochs=num_epochs,
               save_every=save_every, save_path=save_path, log_every=log_every,
               writer=writer)
