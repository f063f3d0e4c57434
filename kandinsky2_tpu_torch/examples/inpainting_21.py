"""2.1 inpainting (mask 1 = keep, reference semantics)."""

import numpy as np

from .common import argparser, make_pipe21, random_image


def main(argv=None):
    args = argparser().parse_args(argv)
    pipe, kw = make_pipe21(args, task_type="inpainting")
    size = kw["h"]
    mask = np.ones((size, size), np.float32)
    mask[size // 4: 3 * size // 4, size // 4: 3 * size // 4] = 0
    imgs = pipe.generate_inpainting(args.prompt, random_image(size), mask,
                                    sampler="p_sampler", **kw)
    imgs[0].save(args.out)
    print("saved", args.out, imgs[0].size)


if __name__ == "__main__":
    main()
