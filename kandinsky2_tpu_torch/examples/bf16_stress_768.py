"""Full-size bf16 robustness stress on the card.

Builds the full 2.1 stack (1.22B UNet + 1B prior + CLIP + XLM-R + MoVQ)
with random weights resampled to torch-default init statistics
(``weights.realistic.torch_init_stats``: kaiming_uniform kernels, N(0, 1)
embeddings — the magnitudes a real checkpoint starts from), runs the whole
768² text2img trajectory in bf16, and asserts the output is finite.
``--small`` does the same on the small 2.1 config at 64².

    python -m kandinsky2_tpu_torch.examples.bf16_stress_768 [--steps 20] [--res 768]
"""

import time

import numpy as np
import torch

from .common import argparser, make_pipe21


def main(argv=None):
    from ..weights.realistic import torch_init_stats

    args = argparser().parse_args(argv)
    res = args.res or (64 if args.small else 768)
    steps = args.steps or 20

    if args.small:
        pipe, _ = make_pipe21(args)
    else:
        from ..pipelines import Kandinsky2_1
        from ..utils import stub_tokenizers

        tok1, tok2 = stub_tokenizers()
        pipe = Kandinsky2_1(tokenizer1=tok1, tokenizer2=tok2, dtype=torch.bfloat16,
                            device=args.device)
        print("initializing full-size params (bf16)...")
        pipe.init_random_params(torch.Generator(device=args.device).manual_seed(0))
    print("resampling to torch init statistics...")
    gen = torch.Generator(device=args.device).manual_seed(7)
    for model in pipe.models().values():
        torch_init_stats(model, gen)
    nbytes = sum(p.numel() * p.element_size() for model in pipe.models().values()
                 for p in model.parameters())
    print(f"params: {nbytes / 1e9:.2f} GB bf16 on {pipe.device}")

    t0 = time.time()
    imgs = pipe.generate_text2img(
        "stress", num_steps=steps, h=res, w=res, sampler="ddim_sampler",
        prior_steps="25",
    )
    dt = time.time() - t0
    arr = np.asarray(imgs[0], np.float32)
    assert arr.shape == (res, res, 3), arr.shape
    assert np.isfinite(arr).all(), "non-finite pixels in bf16 output!"
    print(f"OK: finite {res}x{res} bf16 output at torch-init scales "
          f"({steps} steps: {dt:.1f}s)")
    return arr


if __name__ == "__main__":
    main()
