"""Kandinsky 2.2 checkpoints (diffusers snapshots) into the port's
modules, the counterpart of ``kandinsky2_tpu/weights/load_kandinsky22.py``.

The 2.2 weights live in HF diffusers repos: kandinsky-2-2-prior
(image_encoder, text_encoder, tokenizer, prior) and kandinsky-2-2-decoder
(-inpaint, controlnet-depth) (unet, movq).  ``UNet22``,
``PriorTransformer22``, ``HFCLIPVision`` and ``HFCLIPText`` carry the
diffusers state_dict names, so they load mechanically; the MoVQ is a
diffusers ``VQModel`` whose block names differ from the CompVis layout of
``MOVQ``, which ``movq22_rename`` maps.  Each loader fills a module in
place and returns it; keys a checkpoint lacks keep the module's values, as
the JAX loaders keep their init (``strict=False``).
"""

from __future__ import annotations

import os
import re

import torch

from .convert import load_state_dict
from .safetensors_file import load_torch


def _load_diffusers_sd(repo_dir: str, subfolder: str) -> dict:
    """The state dict of ``<repo_dir>/<subfolder>``: its safetensors file
    (``diffusion_pytorch_model`` or ``model``), else its ``.bin``."""
    base = os.path.join(repo_dir, subfolder)
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors"):
        if os.path.exists(os.path.join(base, name)):
            return load_torch(os.path.join(base, name))
    for name in ("diffusion_pytorch_model.bin", "pytorch_model.bin"):
        p = os.path.join(base, name)
        if os.path.exists(p):
            return torch.load(p, map_location="cpu", weights_only=False)
    raise FileNotFoundError(f"no model weights under {base}")


def movq22_rename(torch_key: str) -> str:
    """The port's CompVis-style MOVQ key -> the diffusers VQModel key:
    ``{encoder,decoder}.down_blocks.{i}.resnets.{j}`` and ``.downsamplers.0``,
    ``decoder.up_blocks.{3 - i}`` (the up levels run the other way),
    ``mid_block.resnets.{0,1}`` / ``.attentions.0``, ``conv_shortcut``,
    ``conv_norm_out`` and the attention's ``to_q/to_k/to_v/to_out.0``."""
    k = torch_key
    k = re.sub(r"^(encoder|decoder)\.down\.(\d+)\.block\.(\d+)\.",
               r"\1.down_blocks.\2.resnets.\3.", k)
    k = re.sub(r"^(encoder|decoder)\.down\.(\d+)\.attn\.(\d+)\.",
               r"\1.down_blocks.\2.attentions.\3.", k)
    k = re.sub(r"^(encoder|decoder)\.down\.(\d+)\.downsample\.conv\.",
               r"\1.down_blocks.\2.downsamplers.0.conv.", k)
    m = re.match(r"^decoder\.up\.(\d+)\.(block|attn|upsample)\.(.*)$", k)
    if m:
        level, kind, rest = 3 - int(m.group(1)), m.group(2), m.group(3)
        part = {"block": "resnets.", "attn": "attentions.", "upsample": "upsamplers.0."}
        k = f"decoder.up_blocks.{level}.{part[kind]}{rest}"
    k = re.sub(r"^(encoder|decoder)\.mid\.block_([12])\.",
               lambda m: f"{m.group(1)}.mid_block.resnets.{int(m.group(2)) - 1}.", k)
    k = re.sub(r"^(encoder|decoder)\.mid\.attn_1\.", r"\1.mid_block.attentions.0.", k)
    k = re.sub(r"\bnin_shortcut\b", "conv_shortcut", k)
    k = re.sub(r"\bnorm_out\b", "conv_norm_out", k)
    k = re.sub(r"\.q\.(weight|bias)$", r".to_q.\1", k)
    k = re.sub(r"\.k\.(weight|bias)$", r".to_k.\1", k)
    k = re.sub(r"\.v\.(weight|bias)$", r".to_v.\1", k)
    k = re.sub(r"\.proj_out\.(weight|bias)$", r".to_out.0.\1", k)
    return k


def load_unet22(repo_dir: str, module, subfolder: str = "unet"):
    return load_state_dict(module, _load_diffusers_sd(repo_dir, subfolder), strict=False)


def load_prior22(repo_dir: str, module, subfolder: str = "prior"):
    return load_state_dict(module, _load_diffusers_sd(repo_dir, subfolder), strict=False)


def load_movq22(repo_dir: str, module, subfolder: str = "movq"):
    return load_state_dict(module, _load_diffusers_sd(repo_dir, subfolder),
                           rename=movq22_rename, strict=False)


def load_image_encoder22(repo_dir: str, module, subfolder: str = "image_encoder"):
    return load_state_dict(module, _load_diffusers_sd(repo_dir, subfolder), strict=False)


def load_text_encoder22(repo_dir: str, module, subfolder: str = "text_encoder"):
    return load_state_dict(module, _load_diffusers_sd(repo_dir, subfolder), strict=False)


def build_kandinsky22(prior_dir: str, decoder_dir: str, task_type: str = "text2img",
                      dtype=None, tokenizer=None, device="cuda"):
    """A ``Kandinsky2_2`` on ``device`` from local diffusers snapshots.  The
    module layout comes from the snapshots' config.json files
    (``configs22.pipeline_overrides``), ``num_image_tokens`` from the UNet
    weights' shapes; the tokenizer, where none is given, from
    ``<prior_dir>/tokenizer``."""
    from ..pipelines.kandinsky2_2 import Kandinsky2_2
    from .configs22 import pipeline_overrides

    if tokenizer is None and os.path.isdir(os.path.join(prior_dir, "tokenizer")):
        from ..tokenizers.clip_bpe import CLIPBPETokenizer

        tokenizer = CLIPBPETokenizer.from_hf_dir(os.path.join(prior_dir, "tokenizer"))
    unet_sd = _load_diffusers_sd(decoder_dir, "unet")
    overrides = pipeline_overrides(prior_dir, decoder_dir, task_type, unet_sd=unet_sd)
    pipe = Kandinsky2_2(task_type=task_type, tokenizer=tokenizer,
                        dtype=dtype or torch.bfloat16, overrides=overrides,
                        device=device).cast_models_()
    load_state_dict(pipe.unet, unet_sd, strict=False)
    del unet_sd
    load_movq22(decoder_dir, pipe.movq)
    load_prior22(prior_dir, pipe.prior)
    load_image_encoder22(prior_dir, pipe.image_encoder)
    load_text_encoder22(prior_dir, pipe.text_encoder)
    return pipe

