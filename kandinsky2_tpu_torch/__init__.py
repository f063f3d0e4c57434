"""kandinsky2_tpu_torch — Kandinsky 2.0, 2.1 and 2.2 inference and the 2.1
decoder fine-tuning in PyTorch for an NVIDIA H100, ported from the JAX
package ``kandinsky2_tpu`` (the reference, which this package never
imports).

    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
    pipe = Kandinsky2_1(tokenizer1=..., tokenizer2=...)  # on the card
    pipe.init_random_params(torch.Generator("cuda").manual_seed(0))
    images = pipe.generate_text2img("a red cat", num_steps=50, h=768, w=768)

2.2: ``pipelines.Kandinsky2_2(tokenizer=..., overrides=weights.configs22.
pipeline_overrides(task_type="text2img"))``, the same entry points.  2.0:
``pipelines.Kandinsky2(tokenizer1=..., tokenizer2=...)`` (``CONFIG_2_0``),
with ``generate_text2img``, ``generate_img2img`` and
``generate_inpainting``.

From a local cache of the published checkpoints (the JAX package's
layout; the port downloads nothing)::

    from kandinsky2_tpu_torch import get_kandinsky2
    pipe = get_kandinsky2(model_version="2.2", cache_dir="/path/to/cache")
    pipe = get_kandinsky2(model_version="2.1", cache_dir=...,
                          tokenizers=(xlmr_tokenizer, None))

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


def get_kandinsky2_1(device="cuda", task_type: str = "text2img",
                     cache_dir: str = "/tmp/kandinsky2", use_auth_token=None,
                     use_flash_attention: bool = True, dtype=None, tokenizers=None):
    """The 2.1 pipeline from the cached checkpoints (reference
    kandinsky2/__init__.py:90-161).  ``tokenizers`` is (XLM-R tokenizer,
    CLIP BPE tokenizer or None): the port cannot read the XLM-R
    sentencepiece file, and reads the CLIP BPE vocabulary from the cache
    where the second is None."""
    from .weights.hub import fetch_2_1
    from .weights.load_kandinsky import build_kandinsky21

    tok1, tok2 = tokenizers or (None, None)
    paths = fetch_2_1(cache_dir, task_type, use_auth_token)
    return build_kandinsky21(paths, task_type=task_type, dtype=dtype, tokenizer1=tok1,
                             tokenizer2=tok2, device=device)


def get_kandinsky2(device="cuda", task_type: str = "text2img",
                   cache_dir: str = "/tmp/kandinsky2", use_auth_token=None,
                   model_version: str = "2.1", use_flash_attention: bool = True,
                   dtype=None, tokenizers=None):
    """The pipeline of ``model_version`` from the cached checkpoints, on
    ``device`` (reference kandinsky2/__init__.py:164-192).  2.2 reads its
    tokenizer from the prior snapshot; 2.1 and 2.0 take ``tokenizers``
    (``get_kandinsky2_1``, ``pipelines.kandinsky2_0.get_kandinsky2_0``).
    ``use_auth_token`` and ``use_flash_attention`` are the reference's
    arguments; the first is unused (nothing is downloaded), the routing
    rule of ``ops.attention`` decides the second."""
    if model_version == "2.1":
        return get_kandinsky2_1(device, task_type=task_type, cache_dir=cache_dir,
                                use_auth_token=use_auth_token, dtype=dtype,
                                tokenizers=tokenizers)
    if model_version == "2.2":
        from .weights.hub import fetch_2_2
        from .weights.load_kandinsky22 import build_kandinsky22

        paths = fetch_2_2(cache_dir, task_type, use_auth_token)
        return build_kandinsky22(paths["prior_dir"], paths["decoder_dir"],
                                 task_type=task_type, dtype=dtype, device=device)
    if model_version == "2.0":
        from .pipelines.kandinsky2_0 import get_kandinsky2_0

        return get_kandinsky2_0(device, task_type=task_type, cache_dir=cache_dir,
                                use_auth_token=use_auth_token, dtype=dtype,
                                tokenizers=tokenizers)
    raise ValueError("Only 2.0, 2.1 and 2.2 are available")
