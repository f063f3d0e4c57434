"""2.0 inpainting (reference notebooks/Kandinsky_2_0_inpainting.ipynb):
latent-mask-blended denoising with the inpainting-conditioned UNet.
Mask convention follows the reference: 1 = keep, 0 = repaint."""

import numpy as np

from .common import argparser, make_pipe20, random_image


def main(argv=None):
    args = argparser(image="").parse_args(argv)
    pipe, kw = make_pipe20(args, task_type="inpainting")
    if args.image:
        from PIL import Image

        src = Image.open(args.image).convert("RGB")
    else:
        src = random_image(size=kw["h"])
    h, w = kw.pop("h"), kw.pop("w")
    if args.steps:
        kw["num_steps"] = args.steps
    # repaint the central square, keep the rest (reference notebook's demo mask)
    mask = np.ones((h, w), np.float32)
    mask[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = 0.0
    imgs = pipe.generate_inpainting(
        args.prompt, src, mask, sampler="ddim_sampler", ddim_eta=0.05, **kw,
    )
    imgs[0].save(args.out)
    print("saved", args.out, imgs[0].size)


if __name__ == "__main__":
    main()
