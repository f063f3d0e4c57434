"""Kandinsky 2.2 module hyperparameters from the published configs, the
port's copy of ``kandinsky2_tpu/weights/configs22.py`` reduced to what the
port reads.

The 2.2 architecture lives in the diffusers snapshots' ``config.json``
files; the published values are vendored under ``fixtures22/`` (the same
seven files as the JAX package's, which the port does not read).

* ``*_overrides(cfg)``: a diffusers/HF config dict as constructor kwargs of
  ``UNet22``, ``PriorTransformer22``, ``MOVQ``, ``HFCLIPText`` and
  ``HFCLIPVision``.
* ``pipeline_overrides(task_type)``: the whole ``overrides`` dict of
  ``pipelines.Kandinsky2_2`` from the vendored configs.
"""

from __future__ import annotations

import json
import os

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures22")

_UNET_FIXTURE = {
    "text2img": "decoder__unet",
    "img2img": "decoder__unet",
    "inpainting": "decoder-inpaint__unet",
    "controlnet": "controlnet__unet",
}


def load_fixture(name: str) -> dict:
    """The vendored config dict ``fixtures22/<name>.json``."""
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        return json.load(f)


def unet22_overrides(cfg: dict) -> dict:
    """diffusers UNet2DConditionModel config -> UNet22 kwargs."""
    return dict(
        in_channels=cfg["in_channels"],
        out_channels=cfg["out_channels"],
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg["layers_per_block"],
        attention_head_dim=cfg["attention_head_dim"],
        cross_attention_dim=cfg["cross_attention_dim"],
        encoder_hid_dim=cfg["encoder_hid_dim"],
        down_block_types=tuple(cfg["down_block_types"]),
        up_block_types=tuple(cfg["up_block_types"]),
        eps=cfg["norm_eps"],
        controlnet_hint=cfg["addition_embed_type"] == "image_hint",
    )


def prior22_overrides(cfg: dict) -> dict:
    """diffusers PriorTransformer config -> PriorTransformer22 kwargs."""
    return dict(
        num_attention_heads=cfg["num_attention_heads"],
        attention_head_dim=cfg["attention_head_dim"],
        num_layers=cfg["num_layers"],
        embedding_dim=cfg["embedding_dim"],
        num_embeddings=cfg["num_embeddings"],
        additional_embeddings=cfg["additional_embeddings"],
    )


def movq22_overrides(cfg: dict) -> dict:
    """diffusers VQModel config -> MOVQ kwargs.  An Attn* encoder block at
    level ``i`` of a 256-px codec attends at resolution ``256 / 2**i``."""
    ch0 = cfg["block_out_channels"][0]
    resolution = 256  # pixel resolution the ch_mult ladder is defined at
    attn_res = tuple(
        resolution // (2**i)
        for i, t in enumerate(cfg["down_block_types"])
        if "Attn" in t
    )
    return dict(
        z_channels=cfg["latent_channels"],
        embed_dim=cfg["vq_embed_dim"],
        n_embed=cfg["num_vq_embeddings"],
        ch=ch0,
        ch_mult=tuple(c // ch0 for c in cfg["block_out_channels"]),
        num_res_blocks=cfg["layers_per_block"],
        attn_resolutions=attn_res,
        resolution=resolution,
        out_ch=cfg["out_channels"],
    )


def clip_text_overrides(cfg: dict) -> dict:
    """HF CLIPTextConfig -> HFCLIPText kwargs."""
    return dict(
        vocab_size=cfg["vocab_size"],
        context_length=cfg["max_position_embeddings"],
        hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"],
        intermediate=cfg["intermediate_size"],
        projection_dim=cfg["projection_dim"],
        act=cfg["hidden_act"],
        eps=cfg["layer_norm_eps"],
        eot_token_id=cfg["eos_token_id"],
    )


def clip_vision_overrides(cfg: dict) -> dict:
    """HF CLIPVisionConfig -> HFCLIPVision kwargs (the published tower's
    ``hidden_act`` is the exact, erf GELU)."""
    from ..models.text_encoders import exact_gelu

    return dict(
        image_size=cfg["image_size"],
        patch_size=cfg["patch_size"],
        hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"],
        intermediate=cfg["intermediate_size"],
        projection_dim=cfg["projection_dim"],
        act=exact_gelu,
        eps=cfg["layer_norm_eps"],
    )


def pipeline_overrides(task_type: str) -> dict:
    """The ``overrides`` dict of ``pipelines.Kandinsky2_2`` for
    ``task_type`` from the vendored configs."""
    return {
        "unet": unet22_overrides(load_fixture(_UNET_FIXTURE[task_type])),
        "movq": movq22_overrides(load_fixture("decoder__movq")),
        "prior": prior22_overrides(load_fixture("prior__prior")),
        "text_encoder": clip_text_overrides(load_fixture("prior__text_encoder")),
        "image_encoder": clip_vision_overrides(load_fixture("prior__image_encoder")),
    }
