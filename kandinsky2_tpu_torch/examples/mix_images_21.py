"""2.1 image/text mixing (reference notebooks/kandinsky_2_1_mixing.ipynb)."""

from .common import argparser, make_pipe21, random_image


def main(argv=None):
    args = argparser().parse_args(argv)
    pipe, kw = make_pipe21(args)
    imgs = pipe.mix_images([args.prompt, random_image(64)], [0.5, 0.5], **kw)
    imgs[0].save(args.out)
    print("saved", args.out, imgs[0].size)


if __name__ == "__main__":
    main()
