"""2.2 ControlNet-depth, full notebook flow (reference
notebooks/kandinsky2_2_controlnet.ipynb): RGB photo -> depth hint
(``depth.make_hint``: the DPT network when ``$KANDINSKY2_DPT_DIR`` holds a
local snapshot, on the example's device, else the weightless heuristic) ->
emb2emb priors -> ControlNet img2img decoder.

Pass ``--image photo.jpg`` to control a real photograph; without it a small
procedural scene (sky / ground / box) is rendered so the script runs offline.
"""

import os

import numpy as np
import torch

from .common import argparser, make_pipe22


def procedural_scene(size: int):
    """A photo-like RGB test scene (not a ramp): sky gradient, ground plane,
    and a foreground box, so the depth heuristic has real structure."""
    from PIL import Image

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.zeros((size, size, 3), np.float32)
    sky = yy < 0.45
    img[..., 2] = np.where(sky, 0.9 - 0.5 * yy, 0.25)          # blue sky
    img[..., 1] = np.where(sky, 0.7 - 0.3 * yy, 0.5 + 0.3 * yy)  # ground green
    img[..., 0] = np.where(sky, 0.5 - 0.2 * yy, 0.3 + 0.2 * yy)
    box = (np.abs(xx - 0.5) < 0.12) & (yy > 0.5) & (yy < 0.8)
    img[box] = (0.7, 0.3, 0.2)
    return Image.fromarray((img * 255).astype(np.uint8))


def main(argv=None):
    from ..depth import dpt_estimator, heuristic_depth, make_hint

    args = argparser(image=None).parse_args(argv)
    pipe, kw = make_pipe22(args, task_type="controlnet")
    size = kw.pop("h"), kw.pop("w")

    if args.image:
        from PIL import Image

        photo = Image.open(args.image).convert("RGB").resize((size[1], size[0]))
    else:
        photo = procedural_scene(size[0])

    dpt_dir = os.environ.get("KANDINSKY2_DPT_DIR")
    estimator = dpt_estimator(dpt_dir, device=args.device) if dpt_dir else heuristic_depth
    hint = make_hint(photo, h=size[0], w=size[1], estimator=estimator)

    # notebook prior flow: interpolate -> emb2emb with the image embedding
    clip_emb = pipe.encode_image(photo)
    img_emb = pipe.run_prior_emb2emb(
        clip_emb, args.prompt, strength=0.85, prior_steps=kw.pop("prior_steps"),
    )
    neg_emb = pipe.get_zero_embed(1)
    embs = torch.cat([neg_emb, img_emb], dim=0)

    imgs = pipe.generate_controlnet(
        args.prompt, hint=hint, image=photo, strength=0.5,
        image_embeds=embs, h=size[0], w=size[1], **kw,
    )
    imgs[0].save(args.out)
    print("saved", args.out, imgs[0].size)


if __name__ == "__main__":
    main()
