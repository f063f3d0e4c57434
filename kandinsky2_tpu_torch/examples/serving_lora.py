"""Serving with LoRA hot-swap: two adapters + base model served from one
``GenerationServer`` (each adapter is folded into the weights on a switch
with ``merge_lora``; the reference applies diffusers LoRA attention
processors at runtime instead, notebooks/lora_decoder.ipynb).

    python -m kandinsky2_tpu_torch.examples.serving_lora --small
"""

import time

import numpy as np
import torch

from .common import argparser, make_pipe21


def main(argv=None):
    from ..models.lora import init_lora
    from ..serving import GenerationServer

    args = argparser().parse_args(argv)
    pipe, kw = make_pipe21(args)
    server = GenerationServer(pipe, max_batch=2, batch_window_s=0.1)

    # two "styles": same targets, different factors (init_lora zero-inits `up`
    # => identity; perturb so the adapters actually bite on random weights)
    base_factors = init_lora(pipe.unet, torch.Generator(device=args.device).manual_seed(0),
                             rank=4)
    style_a = {p: {"down": f["down"], "up": f["up"] + 2.0}
               for p, f in base_factors.items()}
    style_b = {p: {"down": f["down"], "up": f["up"] - 2.0}
               for p, f in base_factors.items()}
    server.attach_lora("style-a", style_a)
    server.attach_lora("style-b", style_b, scale=0.5)
    print(f"attached 2 adapters over {len(base_factors)} kernels")

    server.start()
    try:
        t0 = time.time()
        futs = {
            "base": server.submit(args.prompt, **kw),
            "style-a": server.submit(args.prompt, lora="style-a", **kw),
            "style-b": server.submit(args.prompt, lora="style-b", **kw),
        }
        outs = {k: np.asarray(f.result(timeout=1800)[0], np.float32)
                for k, f in futs.items()}
        print(f"3 variants in {time.time() - t0:.1f}s; "
              f"stats: {server.stats()}")
    finally:
        server.stop()

    for a, b in [("base", "style-a"), ("style-a", "style-b")]:
        d = np.abs(outs[a] - outs[b]).max()
        print(f"max|{a} - {b}| = {d:.1f}")
        assert d > 0, "adapters must change the output"
    print("ok")
    return outs


if __name__ == "__main__":
    main()
