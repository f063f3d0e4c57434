"""2.1 decoder fine-tuning on a 1-image dummy dataset, end-to-end
(reference notebooks/train_2_1_unclip.ipynb + train_2_1_unclip.py): the
small pipeline with fp32 parameters computing in bf16 (the training CLI's
policy), ``optax.adafactor`` at 5e-6 through
``train.optim.optimizer_from_config``, the YAML's freeze rules, a save
every 4 steps into a new temporary directory."""

import os
import tempfile

import numpy as np
import torch

from .common import argparser, make_pipe21, random_image


def main(argv=None):
    from ..train.optim import optimizer_from_config
    from ..train.train_unclip import train_unclip

    args = argparser().parse_args(argv)
    args.small = True  # tiny config; swap for real checkpoints
    pipe, _ = make_pipe21(args, param_dtype=torch.float32)

    # 1-image dummy CSV dataset, like the reference training notebook
    tmp = tempfile.mkdtemp()
    random_image(64).save(os.path.join(tmp, "img.png"))
    with open(os.path.join(tmp, "data.csv"), "w") as f:
        f.write("image_name,caption\nimg.png,a test image\n")

    def loader():
        for _ in range(8):
            yield {"image": np.asarray(random_image(64), np.float32) / 127.5 - 1}

    @torch.no_grad()
    def prepare_batch(raw):
        lat = pipe.movq_encode(raw["image"][None]) * pipe.scale
        full, pooled = pipe.encode_text("a test image", 1)
        zero = pipe.create_zero_img_emb(1)
        return {
            "image_latents": lat, "full_emb": full[:1],
            "pooled_emb": pooled[:1], "image_emb": zero,
        }

    state = train_unclip(
        unet=pipe.unet, diffusion_config=pipe.config["diffusion_config"],
        loader=loader(), prepare_batch=prepare_batch,
        optimizer_factory=optimizer_from_config(
            {"name": "optax.adafactor", "params": {"learning_rate": 5e-6}}),
        save_every=4, save_path=os.path.join(tmp, "ckpt"),
        freeze_resblocks=True, log_every=2,
    )
    print("trained to step", int(state.step), "checkpoints in", tmp)
    return state


if __name__ == "__main__":
    main()
