"""Rank-4 LoRA fine-tuning of the 2.2 decoder UNet
(reference: notebooks/lora_decoder.ipynb -> diffusers tune_decoder_lora.py).

Only the {down, up} factor pairs train (``optax.adamw`` at 1e-4 through
``train.optim.optimizer_from_config``); the 1.22B base stays frozen, so
the optimizer state is a few MB.  Synthetic batch here — swap in
MoVQ-encoded latents + ViT-bigG image embeddings from your dataset for
real tuning.
"""

import numpy as np
import torch

from .common import argparser, make_pipe22
from .lora_22 import merge_into


def main(argv=None):
    from ..models.lora import init_lora
    from ..train.optim import optimizer_from_config
    from ..train.train_lora import (
        init_lora_train_state,
        make_lora_train_step,
        nest_loras,
        unet22_eps_fn,
    )

    args = argparser().parse_args(argv)
    pipe, kw = make_pipe22(args)
    dev = args.device

    rank = 4
    loras = init_lora(pipe.unet, torch.Generator(device=dev).manual_seed(0), rank=rank)
    print(f"{len(loras)} attention kernels adapted at rank {rank}")

    tx = optimizer_from_config({"name": "optax.adamw", "params": {"learning_rate": 1e-4}})
    step_fn = make_lora_train_step(unet22_eps_fn(pipe.unet), pipe.unet,
                                   np.asarray(pipe._decoder_acp, np.float64))
    state = init_lora_train_state(loras, tx, seed=1)

    # synthetic latents (stand-in for MoVQ-encoded training images) + image embs
    B, lat = 2, (kw["h"] // 8 if args.small else 96)
    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.normal(size=(B, lat, lat, 4)) * 0.5, dtype=torch.float32,
                      device=dev)
    cond = torch.tensor(rng.normal(size=(B, pipe.unet.encoder_hid_dim)),
                        dtype=torch.float32, device=dev)

    steps = args.steps or 10
    for i in range(steps):
        metrics = step_fn(state, x0, cond)
        if i % max(1, steps // 10) == 0 or i == steps - 1:
            print(f"step {i}: loss {float(metrics['loss']):.4f}")

    merge_into(pipe.unet, {n: {k: v.detach() for k, v in f.items()}
                           for n, f in nest_loras(state.params).items()}, scale=1.0)
    print("merged trained LoRA into the decoder; generating...")
    imgs = pipe.generate_text2img("a portrait in the tuned style", **kw)
    imgs[0].save(args.out)
    print("saved", args.out, imgs[0].size)
    return state


if __name__ == "__main__":
    main()
