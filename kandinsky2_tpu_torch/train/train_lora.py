"""LoRA fine-tuning of the 2.2 decoder UNet, the counterpart of
``kandinsky2_tpu/train/train_lora.py`` (reference: notebooks/
lora_decoder.ipynb, diffusers' tune_decoder_lora) on one device.

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
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..models.lora import merge_lora
from .tensor_state import TensorTrainState, init_tensor_state


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


def make_lora_train_step(eps_fn: Callable, unet: nn.Module, alphas_cumprod):
    """``train_step(state, x0, cond, t=None, noise=None)``, one LoRA step in
    place, returning {"loss"}.

    ``eps_fn(params, x_t, t, cond)`` runs ``unet`` on a {name: tensor}
    dict (``unet22_eps_fn``); the base is ``unet``'s parameters, detached.
    ``alphas_cumprod`` is the base (1000-step) schedule.  t [B] is drawn
    uniformly in [0, T) and the noise (x0's shape) normally, t first,
    unless given; x_t is formed in fp32."""
    base = {n: p.detach() for n, p in unet.named_parameters()}
    device = next(unet.parameters()).device
    acp = torch.as_tensor(np.asarray(alphas_cumprod, np.float32), device=device)
    T = acp.shape[0]

    def train_step(state: TensorTrainState, x0, cond, t=None, noise=None) -> dict:
        B = x0.shape[0]
        if t is None:
            t = torch.randint(0, T, (B,), generator=state.generator, device=device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=state.generator, device=device)
        t = torch.as_tensor(t, device=device).long()
        noise = torch.as_tensor(noise, device=device).float()
        a = acp[t].reshape((B,) + (1,) * (x0.dim() - 1))
        x_t = torch.sqrt(a) * x0.float() + torch.sqrt(1.0 - a) * noise
        eps_hat = eps_fn(merge_lora(base, nest_loras(state.params)), x_t, t.float(), cond)
        loss = ((eps_hat.float() - noise) ** 2).mean()
        loss.backward()
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return {"loss": loss.detach()}

    return train_step


def unet22_eps_fn(unet: nn.Module) -> Callable:
    """``eps_fn`` of the 2.2 decoder UNet (the reference's
    tune_decoder_lora target): ``cond`` is the image embedding [B, D];
    ``encode_conditioning`` then ``denoise`` on ``params``, and the first
    x_t.shape[-1] output channels (the variance channels are not
    trained)."""

    def eps_fn(params, x_t, t, image_embeds):
        out = functional_call(unet, params, (x_t, t, image_embeds))
        return out[..., : x_t.shape[-1]]

    return eps_fn
