"""Two-stage hires text2img (beyond reference): full ladder at half
resolution -> LANCZOS upsample -> light-noise img2img refine at full
resolution, with the prior run once and reused by both stages."""

from .common import argparser, make_pipe21


def main(argv=None):
    args = argparser().parse_args(argv)
    pipe, kw = make_pipe21(args)
    res = args.res or (128 if args.small else 768)
    imgs = pipe.generate_text2img_hires(
        args.prompt, h=res, w=res, sampler="dpmpp_sampler",
        num_steps=args.steps or (6 if args.small else 25),
        prior_steps=kw.get("prior_steps", "25"),
    )
    imgs[0].save(args.out)
    print("saved", args.out, imgs[0].size)


if __name__ == "__main__":
    main()
