"""2.2 text2img (reference notebooks/kandinsky2_2.ipynb)."""

from .common import argparser, make_pipe22


def main(argv=None):
    args = argparser().parse_args(argv)
    pipe, kw = make_pipe22(args)
    imgs = pipe.generate_text2img(args.prompt, **kw)
    imgs[0].save(args.out)
    print("saved", args.out, imgs[0].size)


if __name__ == "__main__":
    main()
