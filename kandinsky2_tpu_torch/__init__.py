"""kandinsky2_tpu_torch — the Kandinsky 2.1 text2img path in PyTorch for an
NVIDIA H100, ported from the JAX package ``kandinsky2_tpu`` (the reference,
which this package never imports).

    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
    pipe = Kandinsky2_1(tokenizer1=..., tokenizer2=..., device="cuda")
    pipe.init_random_params(torch.Generator("cuda").manual_seed(0))
    images = pipe.generate_text2img("a red cat", num_steps=50, h=768, w=768)

The GroupNorm and flash-attention kernels (``ops/``) are written by hand for
Hopper and built at first use into ``kandinsky2_tpu_torch/build/``.
"""

from .configs import CONFIG_2_1

__version__ = "0.1.0"
