"""2.0 text2img (reference notebooks/Kandinsky_2_0_text2img.ipynb)."""

from .common import argparser, make_pipe20


def main(argv=None):
    args = argparser().parse_args(argv)
    pipe, kw = make_pipe20(args)
    if not args.small:  # the entry point's own 512²
        kw.pop("h"), kw.pop("w")
    imgs = pipe.generate_text2img(args.prompt, sampler="ddim_sampler",
                                  ddim_eta=0.05, **kw)
    imgs[0].save(args.out)
    print("saved", args.out, imgs[0].size)


if __name__ == "__main__":
    main()
