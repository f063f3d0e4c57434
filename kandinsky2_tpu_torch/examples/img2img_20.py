"""2.0 img2img (reference notebooks/Kandinsky_2_0_img2img.ipynb):
re-noise the VAE latent of a source image at the strength-derived step and
denoise down the truncated ladder."""

from .common import argparser, make_pipe20, random_image


def main(argv=None):
    args = argparser(strength="0.7", image="").parse_args(argv)
    pipe, kw = make_pipe20(args)
    if args.image:
        from PIL import Image

        src = Image.open(args.image).convert("RGB")
    else:
        src = random_image(size=kw["h"])
    kw.pop("h"), kw.pop("w")
    if args.steps:
        kw["num_steps"] = args.steps
    imgs = pipe.generate_img2img(
        args.prompt, src, strength=float(args.strength), sampler="ddim_sampler",
        ddim_eta=0.05, **kw,
    )
    imgs[0].save(args.out)
    print("saved", args.out, imgs[0].size)


if __name__ == "__main__":
    main()
