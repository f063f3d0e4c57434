"""Prior fine-tuning on dummy CLIP features (reference train_prior.ipynb):
the small 2.1 pipeline's prior with fp32 parameters computing in bf16,
``optax.adafactor`` at 5e-6 through ``train.optim.optimizer_from_config``,
a save every 4 steps into a new temporary directory."""

import os
import tempfile

import numpy as np
import torch

from .common import argparser, make_pipe21


def main(argv=None):
    from ..train.optim import optimizer_from_config
    from ..train.train_prior import train_prior

    args = argparser().parse_args(argv)
    args.small = True
    pipe, _ = make_pipe21(args, param_dtype=torch.float32)
    hp = pipe.config["prior"]["params"]["model"]["hparams"]

    def loader():
        rng = np.random.RandomState(0)
        for _ in range(8):
            yield {
                "image_emb": rng.randn(2, hp["clip_dim"]).astype(np.float32),
                "txt_feat": rng.randn(2, hp["clip_dim"]).astype(np.float32),
                "txt_feat_seq": rng.randn(2, hp["text_ctx"],
                                          hp["clip_xf_width"]).astype(np.float32),
                "mask": np.ones((2, hp["text_ctx"]), bool),
            }

    tmp = tempfile.mkdtemp()
    state = train_prior(
        prior=pipe.prior, diffusion_config=pipe.config["prior"]["params"]["diffusion"],
        loader=loader(),
        prepare_batch=lambda r: {k: torch.as_tensor(v, device=args.device)
                                 for k, v in r.items()},
        optimizer_factory=optimizer_from_config(
            {"name": "optax.adafactor", "params": {"learning_rate": 5e-6}}),
        save_every=4, save_path=os.path.join(tmp, "ckpt"), log_every=2,
    )
    print("trained to step", int(state.step))
    return state


if __name__ == "__main__":
    main()
