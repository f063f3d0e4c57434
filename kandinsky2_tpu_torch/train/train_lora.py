"""LoRA fine-tuning of the 2.2 decoder UNet, the counterpart of
``kandinsky2_tpu/train/train_lora.py`` (reference: notebooks/
lora_decoder.ipynb, diffusers' tune_decoder_lora), on one device or over a
``(data, sp)`` mesh of ranks (``make_sp_lora_train_fn``).

The only trainable tensors are the (down, up) factors of
``models.lora.init_lora``, which the state (``tensor_state``) keeps flat
(``flatten_loras``); the base parameters are read, never updated and never
given a gradient, so the optimizer state is a few MB.  Each step
merges the factors into the base (``merge_lora``: a handful of rank-r
matmuls), runs the UNet on the merged weights through
``torch.func.functional_call``, takes the eps-MSE loss and differentiates
in the factors alone.

Each step draws t, then the noise, from the state's generator unless the
caller passes them; the tests pass the JAX step's draws.

Sharded (``data_axis`` / ``sp_axis``, ``parallel.mesh.MeshAxis``): each
rank holds its examples and, over ``sp``, its latent rows; the UNet runs
row-sharded (``models/unet22.py``), the loss is ``pmean``'d over sp, the
factors' gradients over sp and then data (the transpose argument of
``train_unclip``), so every rank takes the same update and the factors
stay replicated.  The frozen base is replicated and never changes.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..models.lora import merge_lora
from ..parallel import spatial as _sp
from ..parallel.collectives import pmean, pmean_grads
from .tensor_state import TensorTrainState, init_tensor_state
from .train_unclip import _shard_generators, shard_example_rows


def flatten_loras(loras: dict) -> dict:
    """{name: {"down", "up"}} -> {"<name>.down": down, "<name>.up": up}."""
    return {f"{n}.{k}": v for n, f in loras.items() for k, v in f.items()}


def nest_loras(flat: dict) -> dict:
    """The inverse of ``flatten_loras``: the {name: {"down", "up"}} that
    ``merge_lora`` takes."""
    loras = {}
    for key, v in flat.items():
        name, k = key.rsplit(".", 1)
        loras.setdefault(name, {})[k] = v
    return loras


def init_lora_train_state(loras: dict, optimizer_factory: Callable,
                          seed: int = 0) -> TensorTrainState:
    """A state over trainable copies of ``loras``' factors, flattened
    (``flatten_loras``), with ``optimizer_factory(factors)`` and a generator
    seeded with ``seed`` on the factors' device."""
    return init_tensor_state(flatten_loras(loras), optimizer_factory, seed)


def make_lora_train_step(eps_fn: Callable, unet: nn.Module, alphas_cumprod, *,
                         data_axis=None, sp_axis=None):
    """``train_step(state, x0, cond, t=None, noise=None)``, one LoRA step in
    place, returning {"loss"}.

    ``eps_fn(params, x_t, t, cond)`` runs ``unet`` on a {name: tensor}
    dict (``unet22_eps_fn``); the base is ``unet``'s parameters, detached.
    ``alphas_cumprod`` is the base (1000-step) schedule.  t [B] is drawn
    uniformly in [0, T) and the noise (x0's shape) normally, t first,
    unless given; x_t is formed in fp32.

    ``data_axis`` / ``sp_axis`` (``parallel.mesh.MeshAxis``; see
    ``make_sp_lora_train_fn``): x0, ``cond``, ``t`` and ``noise`` are this
    rank's shard (its examples, and over ``sp_axis`` its latent rows);
    undrawn t and noise come from ``train_unclip._shard_generators`` (one
    t an example across the sp group, each rank its own noise rows).  The
    UNet runs row-sharded over ``sp_axis`` for the step; the loss is
    ``pmean``'d over sp, the factors' gradients ``pmean_grads``'d over
    sp, then data, and the returned loss over data."""
    base = {n: p.detach() for n, p in unet.named_parameters()}
    device = next(unet.parameters()).device
    acp = torch.as_tensor(np.asarray(alphas_cumprod, np.float32), device=device)
    T = acp.shape[0]
    sharded = data_axis is not None or sp_axis is not None

    def train_step(state: TensorTrainState, x0, cond, t=None, noise=None) -> dict:
        B = x0.shape[0]
        gen_t = gen_n = state.generator
        if sharded and (t is None or noise is None):
            gen_t, gen_n = _shard_generators(state.generator, data_axis, sp_axis)
        if t is None:
            t = torch.randint(0, T, (B,), generator=gen_t, device=device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=gen_n, device=device)
        t = torch.as_tensor(t, device=device).long()
        noise = torch.as_tensor(noise, device=device).float()
        a = acp[t].reshape((B,) + (1,) * (x0.dim() - 1))
        x_t = torch.sqrt(a) * x0.float() + torch.sqrt(1.0 - a) * noise
        with _sp.using_sp_axes(sp_axis, unet):
            eps_hat = eps_fn(merge_lora(base, nest_loras(state.params)), x_t, t.float(),
                             cond)
            loss = ((eps_hat.float() - noise) ** 2).mean()
            if sp_axis is not None:
                # equal row shards: the mean over the axis is the image's
                loss = pmean(loss, sp_axis)
            loss.backward()
        factors = list(state.params.values())
        for axis in (sp_axis, data_axis):
            if axis is not None:
                pmean_grads(factors, axis)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        loss = loss.detach()
        if data_axis is not None:
            loss = pmean(loss, data_axis)
        return {"loss": loss}

    return train_step


def make_sp_lora_train_fn(eps_fn: Callable, unet: nn.Module, alphas_cumprod,
                          optimizer_factory: Callable, mesh, *, data_axis="data",
                          sp_axis="sp"):
    """(init_state, train_fn): the LoRA step over a ``(data, sp)``
    ``parallel.mesh.Mesh`` of ranks, examples sharded over ``data_axis``,
    latent ROWS over ``sp_axis``, the factors, their optimizer and the
    frozen base replicated (``kandinsky2_tpu/train/train_lora.py:112-142``).
    Row sharding divides the frozen UNet's activation memory, forward and
    backward, by the sp size: LoRA tuning at sizes past one card.
    ``data_axis`` None: an sp-only mesh.

    ``init_state(loras, seed=0)`` is ``init_lora_train_state`` with
    ``optimizer_factory``.  ``train_fn(state, x0, cond, t=None,
    noise=None, sharded=False)`` runs one step on every rank: x0 (and
    ``noise``, its shape) [B, H, W, C], ``cond`` and ``t`` [B, ...] are the
    whole batch, the same on every rank, unless ``sharded``, where they
    are this rank's shard already; x0 and the noise shard over (data, sp),
    the rest over data (JAX's specs).  The batch must divide by the data
    size and the latent rows by ``sp * 2^(levels-1)``.  Every rank calls it
    with the same arguments."""
    sp = mesh.axis(sp_axis)
    data = None if data_axis is None else mesh.axis(data_axis)
    train_step = make_lora_train_step(eps_fn, unet, alphas_cumprod, data_axis=data,
                                      sp_axis=sp)
    levels = len(unet.block_out_channels)

    def init_state(loras: dict, seed: int = 0) -> TensorTrainState:
        return init_lora_train_state(loras, optimizer_factory, seed)

    def train_fn(state: TensorTrainState, x0, cond, t=None, noise=None,
                 sharded: bool = False) -> dict:
        if not sharded:
            _sp.check_sp_rows(x0.shape[1], sp.size, levels)
            x0, cond = shard_example_rows(x0, data, sp), shard_example_rows(cond, data, None)
            t = None if t is None else shard_example_rows(t, data, None)
            noise = None if noise is None else shard_example_rows(noise, data, sp)
        return train_step(state, x0, cond, t, noise)

    return init_state, train_fn


def unet22_eps_fn(unet: nn.Module, sp_axis=None) -> Callable:
    """``eps_fn`` of the 2.2 decoder UNet (the reference's
    tune_decoder_lora target): ``cond`` is the image embedding [B, D];
    ``encode_conditioning`` then ``denoise`` on ``params``, and the first
    x_t.shape[-1] output channels (the variance channels are not
    trained).  ``sp_axis`` (a ``parallel.mesh.MeshAxis``): x_t is this
    rank's rows and the UNet runs row-sharded over the axis."""

    def eps_fn(params, x_t, t, image_embeds):
        with _sp.using_sp_axes(sp_axis, unet):
            out = functional_call(unet, params, (x_t, t, image_embeds))
        return out[..., : x_t.shape[-1]]

    return eps_fn
