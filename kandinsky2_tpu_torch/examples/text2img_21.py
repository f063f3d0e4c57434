"""2.1 text2img (reference notebooks/kandinsky_2_1_text2img.ipynb)."""

from .common import argparser, make_pipe21


def main(argv=None):
    args = argparser().parse_args(argv)
    pipe, kw = make_pipe21(args)
    if args.steps:
        kw["num_steps"] = args.steps
    if args.res:
        kw["h"] = kw["w"] = args.res
    imgs = pipe.generate_text2img(args.prompt, sampler="p_sampler", **kw)
    imgs[0].save(args.out)
    print("saved", args.out, imgs[0].size)


if __name__ == "__main__":
    main()
