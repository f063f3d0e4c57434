"""2.1 img2img."""

from .common import argparser, make_pipe21, random_image


def main(argv=None):
    args = argparser().parse_args(argv)
    pipe, kw = make_pipe21(args)
    imgs = pipe.generate_img2img(args.prompt, random_image(64), strength=0.6, **kw)
    imgs[0].save(args.out)
    print("saved", args.out, imgs[0].size)


if __name__ == "__main__":
    main()
