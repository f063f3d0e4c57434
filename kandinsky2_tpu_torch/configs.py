"""Kandinsky 2.0 and 2.1 configurations and the UNet factory, free of JAX.

``CONFIG_2_0``, ``CONFIG_2_1``, ``parse_channel_mult``,
``parse_attention_ds`` and ``schedule_kwargs`` are copies of their
counterparts in ``kandinsky2_tpu/configs.py`` (the JAX package's module
imports jax and its flax UNets at import time, so it is copied rather than
imported).  ``create_model`` builds the PyTorch ``Text2ImUNet20`` or
``Text2ImUNet21`` by ``version``, or with ``inpainting`` their inpainting
variants.
"""

from __future__ import annotations

import copy
from typing import Any

import torch

CONFIG_2_0: dict[str, Any] = {
    "model_config": {
        "image_size": 64,
        "num_channels": 384,
        "num_res_blocks": 3,
        "channel_mult": "",
        "num_heads": 1,
        "num_head_channels": 64,
        "num_heads_upsample": -1,
        "attention_resolutions": "32,16,8",
        "dropout": 0,
        "model_dim": 768,
        "use_scale_shift_norm": True,
        "resblock_updown": True,
        "use_fp16": False,
        "cache_text_emb": True,
        "text_encoder_in_dim1": 1024,
        "text_encoder_in_dim2": 640,
        "pooling_type": "from_model",
        "in_channels": 4,
        "out_channels": 8,
        "up": False,
        "inpainting": False,
    },
    "diffusion_config": {
        "learn_sigma": True,
        "sigma_small": False,
        "steps": 1000,
        "noise_schedule": "linear",
        "timestep_respacing": "",
        "use_kl": False,
        "predict_xstart": False,
        "rescale_timesteps": True,
        "rescale_learned_sigmas": True,
        "linear_start": 0.0001,
        "linear_end": 0.02,
    },
    "image_enc_params": {
        "name": "AutoencoderKL",
        "scale": 0.0512,
        "params": {
            "embed_dim": 4,
            "ddconfig": {
                "double_z": True,
                "z_channels": 4,
                "resolution": 256,
                "in_channels": 3,
                "out_ch": 3,
                "ch": 128,
                "ch_mult": [1, 2, 4, 4],
                "num_res_blocks": 2,
                "attn_resolutions": [],
                "dropout": 0.0,
            },
        },
    },
    "text_enc_params1": {"model_path": "", "model_name": "multiclip"},
    "text_enc_params2": {"model_path": "", "model_name": "MT5EncoderModel"},
    "tokenizer_name1": "",
    "tokenizer_name2": "",
}

CONFIG_2_1: dict[str, Any] = {
    "clip_name": "ViT-L/14",
    "clip_image_size": 224,
    "tokenizer_name": "",
    "image_enc_params": {
        "name": "MOVQ",
        "scale": 1,
        "ckpt_path": "",
        "params": {
            "embed_dim": 4,
            "n_embed": 16384,
            "ddconfig": {
                "double_z": False,
                "z_channels": 4,
                "resolution": 256,
                "in_channels": 3,
                "out_ch": 3,
                "ch": 128,
                "ch_mult": [1, 2, 2, 4],
                "num_res_blocks": 2,
                "attn_resolutions": [32],
                "dropout": 0.0,
            },
        },
    },
    "text_enc_params": {
        "model_path": "",
        "model_name": "multiclip",
        "in_features": 1024,
        "out_features": 768,
    },
    "prior": {
        "clip_mean_std_path": "ViT-L-14_stats.th",
        "params": {
            "model": {
                "type": "prior",
                "diffusion_sampler": "uniform",
                "hparams": {
                    "text_ctx": 77,
                    "xf_width": 2048,
                    "xf_layers": 20,
                    "xf_heads": 32,
                    "xf_final_ln": True,
                    "xf_padding": False,
                    "text_drop": 0.2,
                    "clip_dim": 768,
                    "clip_xf_width": 768,
                },
            },
            "diffusion": {
                "steps": 1000,
                "learn_sigma": False,
                "sigma_small": True,
                "noise_schedule": "cosine",
                "use_kl": False,
                "predict_xstart": True,
                "rescale_learned_sigmas": False,
                "timestep_respacing": "",
            },
        },
    },
    "model_config": {
        "version": "2.1",
        "image_size": 64,
        "num_channels": 384,
        "num_res_blocks": 3,
        "channel_mult": "",
        "num_heads": 1,
        "num_head_channels": 64,
        "num_heads_upsample": -1,
        "attention_resolutions": "32,16,8",
        "dropout": 0,
        "model_dim": 768,
        "use_scale_shift_norm": True,
        "resblock_updown": True,
        "use_fp16": True,
        "cache_text_emb": True,
        "text_encoder_in_dim1": 1024,
        "text_encoder_in_dim2": 768,
        "image_encoder_in_dim": 768,
        "num_image_embs": 10,
        "pooling_type": "from_model",
        "in_channels": 4,
        "out_channels": 8,
        "use_flash_attention": False,
    },
    "diffusion_config": {
        "learn_sigma": True,
        "sigma_small": False,
        "steps": 1000,
        "noise_schedule": "linear",
        "timestep_respacing": "",
        "use_kl": False,
        "predict_xstart": False,
        "rescale_timesteps": True,
        "rescale_learned_sigmas": True,
        "linear_start": 0.00085,
        "linear_end": 0.012,
    },
}


def parse_channel_mult(channel_mult: str, image_size: int):
    """model_creation.py:34-44."""
    if channel_mult == "":
        return {256: (1, 1, 2, 2, 4, 4), 128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4)}[
            image_size
        ]
    return tuple(int(m) for m in channel_mult.split(","))


def parse_attention_ds(attention_resolutions: str, image_size: int):
    """model_creation.py:46-48: pixel resolutions -> downsample rates."""
    return tuple(image_size // int(r) for r in attention_resolutions.split(","))


def create_model(
    *,
    image_size,
    num_channels,
    num_res_blocks,
    channel_mult,
    attention_resolutions,
    num_heads,
    num_head_channels,
    num_heads_upsample,
    use_scale_shift_norm,
    model_dim,
    resblock_updown,
    use_fp16,
    text_encoder_in_dim1,
    text_encoder_in_dim2,
    pooling_type,
    in_channels,
    out_channels,
    inpainting=False,
    version="2.0",
    image_encoder_in_dim=768,
    num_image_embs=10,
    dtype=None,
    device=None,
    **_unused,
):
    """Config dict -> UNet (model_creation.py:9-83): ``Text2ImUNet20`` for
    ``version`` "2.0", ``Text2ImUNet21`` for "2.1", or with ``inpainting``
    their inpainting variants of 2C + 1 input channels.  ``dtype`` is the
    activation dtype; parameters stay float32 as in the JAX package."""
    from .models import unet

    if dtype is None:
        dtype = torch.bfloat16 if use_fp16 else torch.float32
    common = dict(
        in_channels=in_channels * 2 + 1 if inpainting else in_channels,
        model_channels=num_channels,
        out_channels=out_channels,
        num_res_blocks=num_res_blocks,
        attention_resolutions=parse_attention_ds(attention_resolutions, image_size),
        channel_mult=parse_channel_mult(channel_mult, image_size),
        num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown,
        model_dim=model_dim,
        text_encoder_in_dim1=text_encoder_in_dim1,
        text_encoder_in_dim2=text_encoder_in_dim2,
        dtype=dtype,
        device=device,
    )
    if version == "2.0":
        cls = unet.InpaintText2ImUNet20 if inpainting else unet.Text2ImUNet20
        return cls(pooling_type=pooling_type, **common)
    if version != "2.1":
        raise ValueError(f"unknown version {version}")
    cls = unet.InpaintText2ImUNet21 if inpainting else unet.Text2ImUNet21
    return cls(image_encoder_in_dim=image_encoder_in_dim,
               num_image_embs=num_image_embs, pooling_type=pooling_type, **common)


def schedule_kwargs(diffusion_config: dict, timestep_respacing=None) -> dict:
    """diffusion_config dict -> make_schedule kwargs + sampler types
    (model_creation.py:86-128)."""
    from .diffusion.gaussian import LossType, MeanType, VarType

    dc = diffusion_config
    if dc.get("use_kl"):
        loss_type = LossType.RESCALED_KL
    elif dc.get("rescale_learned_sigmas"):
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    mean_type = MeanType.START_X if dc.get("predict_xstart") else MeanType.EPSILON
    if dc.get("learn_sigma"):
        var_type = VarType.LEARNED_RANGE
    else:
        var_type = VarType.FIXED_SMALL if dc.get("sigma_small") else VarType.FIXED_LARGE
    respacing = (
        timestep_respacing
        if timestep_respacing is not None
        else dc.get("timestep_respacing", "")
    )
    return dict(
        make_schedule=dict(
            steps=dc.get("steps", 1000),
            noise_schedule=dc.get("noise_schedule", "linear"),
            timestep_respacing=respacing,
            linear_start=dc.get("linear_start", 0.0001),
            linear_end=dc.get("linear_end", 0.02),
            rescale_timesteps=dc.get("rescale_timesteps", False),
        ),
        mean_type=mean_type,
        var_type=var_type,
        loss_type=loss_type,
    )


def deep_copy_config(cfg: dict) -> dict:
    return copy.deepcopy(cfg)


def small_config(head_channels: int = 32) -> dict:
    """The ``bench.py --small`` configuration (bench.py:142-172): every 2.1
    model at a narrow width and a depth of 1-2.  ``head_channels`` sets the
    UNet's head width; the flash kernel is built for 64."""
    cfg = deep_copy_config(CONFIG_2_1)
    cfg["model_config"].update(
        num_channels=64, num_res_blocks=1, channel_mult="1,2",
        attention_resolutions="32", num_head_channels=head_channels, model_dim=64,
        text_encoder_in_dim1=48, text_encoder_in_dim2=64,
        image_encoder_in_dim=64, num_image_embs=2,
    )
    cfg["prior"]["params"]["model"]["hparams"].update(
        text_ctx=8, xf_width=128, xf_layers=2, xf_heads=4, clip_dim=64,
        clip_xf_width=64,
    )
    cfg["clip_text_params"] = dict(
        vocab_size=256, context_length=8, width=64, layers=2, heads=4,
        embed_dim=64,
    )
    cfg["clip_vision_params"] = dict(
        image_size=28, patch_size=14, width=64, layers=2, heads=4, embed_dim=64,
    )
    cfg["clip_image_size"] = 28
    cfg["text_enc_params"].update(
        in_features=48, out_features=64, layers=2, heads=4, intermediate=96,
        vocab_size=256, max_positions=40,
    )
    ie = cfg["image_enc_params"]["params"]
    ie["n_embed"] = 64
    ie["ddconfig"].update(ch=32, ch_mult=[1, 1, 1, 2], num_res_blocks=1,
                          attn_resolutions=[8], resolution=64)
    return cfg


def small_config20(head_channels: int = 16) -> dict:
    """``tests/test_pipeline20.py``'s ``tiny_config20``: every 2.0 model at a
    narrow width and a depth of 1-2 (the mT5 at its fixed 512 width, a
    4-level KL-VAE of width 32 whose mid attention is 64 wide).
    ``head_channels=64`` widens the UNet to 64 channels with 64-wide heads,
    the width the flash kernel takes."""
    cfg = deep_copy_config(CONFIG_2_0)
    cfg["model_config"].update(
        num_channels=64 if head_channels == 64 else 32, num_res_blocks=1,
        channel_mult="1,2", attention_resolutions="32",
        num_head_channels=head_channels, model_dim=32, text_encoder_in_dim1=24,
        text_encoder_in_dim2=20)
    cfg["text_enc_params1"] = dict(
        model_name="multiclip", in_features=24, out_features=20, layers=2, heads=4,
        intermediate=48, vocab_size=64, max_positions=40)
    cfg["t5_params"] = dict(
        vocab_size=64, d_model=512, d_kv=16, d_ff=64, num_layers=2, num_heads=4,
        rel_buckets=8, rel_max_distance=20)
    cfg["image_enc_params"]["params"]["ddconfig"].update(
        ch=32, ch_mult=[1, 1, 1, 2], num_res_blocks=1, attn_resolutions=[],
        resolution=64)
    return cfg


def small_overrides22(head_channels: int = 64) -> dict:
    """The per-model overrides of a small ``Kandinsky2_2``:
    ``tests/test_pipeline22.py``'s TINY towers, prior and MoVQ (whose
    attention is 64 wide) with a UNet of 64-wide heads, the width the flash
    kernel takes; ``head_channels=32`` is TINY's own UNet.  Its stand-in
    tokenizer is ``utils.stub_tokenizer22(64)``."""
    wide = head_channels == 64
    return dict(
        image_encoder=dict(image_size=28, patch_size=14, hidden=32, layers=2, heads=4,
                           intermediate=64, projection_dim=32),
        text_encoder=dict(vocab_size=64, context_length=8, hidden=32, layers=2,
                          heads=4, intermediate=64, projection_dim=32, eot_token_id=63),
        prior=dict(num_attention_heads=4, attention_head_dim=16, num_layers=2,
                   embedding_dim=32, num_embeddings=8),
        unet=dict(block_out_channels=(64, 128) if wide else (32, 64),
                  layers_per_block=1, attention_head_dim=head_channels,
                  cross_attention_dim=32, encoder_hid_dim=32, num_image_tokens=2),
        movq=dict(z_channels=4, embed_dim=4, n_embed=32, ch=32, ch_mult=(1, 1, 1, 2),
                  num_res_blocks=1, attn_resolutions=(8,), resolution=64),
    )
