"""Rank-4 LoRA on the 2.2 decoder (reference notebooks/lora_decoder.ipynb):
init factors, merge as a weight delta, generate."""

import torch

from .common import argparser, make_pipe22


def merge_into(unet: torch.nn.Module, loras: dict, scale: float = 1.0) -> None:
    """Fold ``loras`` into ``unet``'s weights in place (``merge_lora``)."""
    from ..models.lora import merge_lora

    weights = dict(unet.named_parameters())
    with torch.no_grad():
        merged = merge_lora({n: weights[n] for n in loras}, loras, scale=scale)
        for n in loras:
            weights[n].copy_(merged[n])


def main(argv=None):
    from ..models.lora import init_lora

    args = argparser().parse_args(argv)
    pipe, kw = make_pipe22(args)
    loras = init_lora(pipe.unet, torch.Generator(device=args.device).manual_seed(0),
                      rank=4)
    print(f"{len(loras)} attention kernels adapted")
    merge_into(pipe.unet, loras, scale=1.0)
    imgs = pipe.generate_text2img(args.prompt, **kw)
    imgs[0].save(args.out)
    print("saved", args.out, imgs[0].size)


if __name__ == "__main__":
    main()
