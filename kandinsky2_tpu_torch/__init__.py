"""kandinsky2_tpu_torch — Kandinsky 2.0, 2.1 and 2.2 inference and the 2.1
decoder fine-tuning in PyTorch for an NVIDIA H100, ported from the JAX
package ``kandinsky2_tpu`` (the reference, which this package never
imports).

    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
    pipe = Kandinsky2_1(tokenizer1=..., tokenizer2=...)  # on the card
    pipe.init_random_params(torch.Generator("cuda").manual_seed(0))
    images = pipe.generate_text2img("a red cat", num_steps=50, h=768, w=768)

2.2: ``pipelines.Kandinsky2_2(tokenizer=..., overrides=weights.configs22.
pipeline_overrides("text2img"))``, the same entry points.  2.0:
``pipelines.Kandinsky2(tokenizer1=..., tokenizer2=...)`` (``CONFIG_2_0``),
with ``generate_text2img``, ``generate_img2img`` and
``generate_inpainting``.

Decoder fine-tuning: ``python -m kandinsky2_tpu_torch.train.train_2_1_unclip
--config train_configs/config_unclip_2_1.yaml`` (``train/``).

The entry points (``Kandinsky2``, ``Kandinsky2_1``, ``Kandinsky2_2``, the CLI's
``build_pipeline`` and ``run``)
run on the card unless given ``device="cpu"``, as the CPU tests do.

The GroupNorm and flash-attention kernels, forward and backward (``ops/``),
are written by hand for Hopper and built at first use into
``kandinsky2_tpu_torch/build/``.
"""

from .configs import CONFIG_2_0, CONFIG_2_1

__version__ = "0.1.0"
