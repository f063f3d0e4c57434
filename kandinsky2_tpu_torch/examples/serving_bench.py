"""Batched-serving throughput on the card: N distinct prompts served
sequentially (batch 1 each) against coalesced into one call by
``GenerationServer``.

    python -m kandinsky2_tpu_torch.examples.serving_bench [--small] [--n 4] \\
        [--steps 20] [--res 256]

Without ``--small`` the pipeline is CONFIG_2_1 at full width with random
bf16 weights (serving time does not depend on the weights)."""

import json
import time

import torch

from .common import argparser, make_pipe21


def main(argv=None):
    from ..serving import GenerationServer

    args = argparser(n="4", sampler="").parse_args(argv)
    n = int(args.n)
    if args.small:
        pipe, kw = make_pipe21(args)
    else:
        from ..configs import CONFIG_2_1
        from ..pipelines import Kandinsky2_1
        from ..utils import stub_tokenizers

        tok1, tok2 = stub_tokenizers()
        pipe = Kandinsky2_1(config=CONFIG_2_1, tokenizer1=tok1, tokenizer2=tok2,
                            dtype=torch.bfloat16, device=args.device)
        pipe.init_random_params(torch.Generator(device=args.device).manual_seed(0))
        kw = dict(num_steps=50, h=768, w=768, sampler="ddim_sampler",
                  prior_steps="25")
    if args.steps:
        kw["num_steps"] = args.steps
    if args.res:
        kw["h"] = kw["w"] = args.res
    if args.sampler:
        kw["sampler"] = args.sampler
    prompts = [f"a photo of a {x}" for x in
               ["red cat", "blue dog", "green bird", "yellow fish",
                "purple horse", "orange fox", "black swan", "white wolf"]][:n]

    server = GenerationServer(pipe, max_batch=n, batch_window_s=0.2)
    print("warmup (runs each batch bucket once)...")
    server.warmup([dict(kw)])

    def sync():
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)

    # sequential: one call per prompt (the pre-batching behavior)
    sync()
    t0 = time.time()
    for p in prompts:
        pipe.generate_text2img([p], batch_size=1, **kw)
    sync()
    seq_s = time.time() - t0

    # coalesced: all prompts in one call via the server
    server.start()
    try:
        t0 = time.time()
        futs = [server.submit(p, **kw) for p in prompts]
        for f in futs:
            f.result(timeout=1200)
        batched_s = time.time() - t0
    finally:
        server.stop()

    result = {
        "metric": f"serving throughput {n} distinct prompts "
                  f"{kw['h']}^2/{kw['num_steps']}-step",
        "sequential_s": round(seq_s, 3),
        "coalesced_s": round(batched_s, 3),
        "speedup": round(seq_s / batched_s, 3),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
