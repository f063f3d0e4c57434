"""The reference's 2.1 and 2.0 torch checkpoints into the port's
pipelines, the counterpart of ``kandinsky2_tpu/weights/load_kandinsky.py``.

The port's models carry the reference's module names, so loading is
``torch.load`` -> ``convert.load_state_dict``:

  decoder_fp16.ckpt / inpainting_fp16.ckpt -> Text2ImUNet21
  prior_fp16.ckpt (keys ``model.*``)       -> PriorTransformer
  movq_final.ckpt                          -> MOVQ
  text_encoder/pytorch_model.bin           -> MultilingualCLIP (XLM-R + head)
  ViT-L-14.pt (OpenAI jit archive)         -> CLIPTextTower + CLIPViT
  ViT-L-14_stats.th                        -> (clip_mean, clip_std)

and for 2.0 ``Kandinsky-2-0*.pt`` (Text2ImUNet20), ``vae.ckpt``
(AutoencoderKL), ``text_encoder1/`` (XLM-R) and ``text_encoder2/`` (mT5).
The XLM-R and mT5 tokenizers are sentencepiece files that only
``transformers`` reads, which the port does without: ``build_kandinsky21``
and ``build_kandinsky20`` take them as arguments (any callable with the HF tokenizer's call contract).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .convert import clip_rename, load_state_dict
from .hub import CLIP_BPE_URL, cached_file


def _load_sd(path: str) -> dict:
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def load_unet21(path: str, module, inpainting: bool = False):
    """The 2.1 UNet (the inpainting one has the same keys, 9 input
    channels)."""
    return load_state_dict(module, _load_sd(path))


def load_prior21(path: str, module):
    return load_state_dict(module, _load_sd(path), prefix="model.")


def load_movq(path: str, module):
    return load_state_dict(module, _load_sd(path))


def load_text_encoder21(model_dir: str, module):
    """``<model_dir>/pytorch_model.bin`` (keys ``transformer.*`` and
    ``LinearTransformation.*``) into a ``TextEncoder``, whose
    MultilingualCLIP sits under ``model.``."""
    return load_state_dict(module, _load_sd(os.path.join(model_dir, "pytorch_model.bin")),
                           rename=lambda k: k[len("model."):], strict=False)


def load_clip_vit_l14(path: str, text_module, vision_module):
    """An OpenAI CLIP jit archive into the text tower and (its ``visual.``
    keys) the vision tower."""
    sd = torch.jit.load(path, map_location="cpu").state_dict()
    text_sd = {k: v for k, v in sd.items() if not k.startswith("visual.")}
    vis_sd = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
    load_state_dict(text_module, text_sd, rename=clip_rename, strict=False)
    load_state_dict(vision_module, vis_sd, rename=clip_rename, strict=False)
    return text_module, vision_module


def load_clip_stats(path: str):
    """(clip_mean, clip_std) as float32 numpy arrays."""
    mean, std = torch.load(path, map_location="cpu", weights_only=False)
    return np.asarray(mean.float().numpy()), np.asarray(std.float().numpy())


def _required(tokenizer, what: str):
    if tokenizer is None:
        raise ValueError(
            f"no {what} given: it is a sentencepiece tokenizer that only "
            "transformers reads, which the port does without; pass it as an "
            "argument (a callable with the HF tokenizer's call contract)")
    return tokenizer


def build_kandinsky21(paths: dict, task_type: str = "text2img", dtype=None,
                      tokenizer1=None, tokenizer2=None, device="cuda"):
    """A ``Kandinsky2_1`` on ``device`` from the files of
    ``hub.fetch_2_1`` (or the same local files).  ``tokenizer1`` is the
    XLM-R tokenizer of ``paths["text_encoder"]``, which must be given;
    ``tokenizer2``, the CLIP BPE one, is read from ``paths["bpe"]`` where
    not given."""
    from ..pipelines.kandinsky2_1 import Kandinsky2_1
    from ..tokenizers import CLIPBPETokenizer

    tokenizer1 = _required(tokenizer1, "tokenizer1 (the XLM-R tokenizer of "
                           f"{paths['text_encoder']})")
    if tokenizer2 is None:
        tokenizer2 = CLIPBPETokenizer(cached_file(paths["bpe"], CLIP_BPE_URL))
    clip_mean, clip_std = load_clip_stats(paths["clip_stats"])
    pipe = Kandinsky2_1(tokenizer1=tokenizer1, tokenizer2=tokenizer2,
                        clip_mean=clip_mean, clip_std=clip_std, task_type=task_type,
                        dtype=dtype or torch.bfloat16, device=device).cast_models_()
    load_unet21(paths["decoder"], pipe.unet, inpainting=task_type == "inpainting")
    load_prior21(paths["prior"], pipe.prior)
    load_movq(paths["movq"], pipe.movq)
    load_text_encoder21(paths["text_encoder"], pipe.text_encoder)
    load_clip_vit_l14(paths["clip"], pipe.clip_text, pipe.clip_vision)
    return pipe


def build_kandinsky20(paths: dict, task_type: str = "text2img", dtype=None,
                      tokenizer1=None, tokenizer2=None, device="cuda"):
    """A ``Kandinsky2`` (2.0) on ``device`` from the files of
    ``hub.fetch_2_0``.  Both tokenizers must be given: ``tokenizer1`` the
    XLM-R one of ``paths["text_encoder1"]``, ``tokenizer2`` the mT5 one of
    ``paths["text_encoder2"]``."""
    from ..pipelines.kandinsky2_0 import Kandinsky2

    tokenizer1 = _required(tokenizer1, "tokenizer1 (the XLM-R tokenizer of "
                           f"{paths['text_encoder1']})")
    tokenizer2 = _required(tokenizer2, "tokenizer2 (the mT5 tokenizer of "
                           f"{paths['text_encoder2']})")
    pipe = Kandinsky2(tokenizer1=tokenizer1, tokenizer2=tokenizer2, task_type=task_type,
                      dtype=dtype or torch.bfloat16, device=device).cast_models_()
    load_state_dict(pipe.unet, _load_sd(paths["unet"]), strict=False)
    load_state_dict(pipe.image_encoder, _load_sd(paths["vae"]), strict=False)
    load_text_encoder21(paths["text_encoder1"], pipe.text_encoder1)
    load_state_dict(pipe.text_encoder2,
                    _load_sd(os.path.join(paths["text_encoder2"], "pytorch_model.bin")),
                    strict=False)
    return pipe
