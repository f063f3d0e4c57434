"""Kandinsky 2.2 module hyperparameters from the checkpoints' configs, the
port's copy of ``kandinsky2_tpu/weights/configs22.py``.

The 2.2 architecture lives in the diffusers snapshots' ``config.json``
files; the published values are vendored under ``fixtures22/`` (the same
seven files as the JAX package's, which the port does not read).

* ``load_model_config(repo_dir, subfolder, fixture)``: a snapshot's own
  ``config.json``, else the vendored fixture (``load_fixture``).
* ``*_overrides(cfg)``: a diffusers/HF config dict as constructor kwargs of
  ``UNet22``, ``PriorTransformer22``, ``MOVQ``, ``HFCLIPText`` and
  ``HFCLIPVision``.
* ``derive_num_image_tokens(sd, cross_attention_dim)``: the ImageProjection
  token count, which is no config.json field, read off the checkpoint's
  ``encoder_hid_proj.image_embeds.weight`` ([tokens · cross_attention_dim,
  encoder_hid_dim]).
* ``pipeline_overrides(prior_dir, decoder_dir, task_type, unet_sd)``: the
  whole ``overrides`` dict of ``pipelines.Kandinsky2_2``, from the
  snapshots (or, with no directories, the vendored configs).
"""

from __future__ import annotations

import json
import os
from typing import Optional

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


def load_model_config(repo_dir: Optional[str], subfolder: str,
                      fixture: Optional[str] = None) -> dict:
    """The config dict of ``<repo_dir>/<subfolder>/config.json``, else the
    vendored fixture ``fixtures22/<fixture or subfolder>.json``."""
    if repo_dir is not None:
        p = os.path.join(repo_dir, subfolder, "config.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
    return load_fixture(fixture or subfolder)


def unet22_overrides(cfg: dict, num_image_tokens: Optional[int] = None) -> dict:
    """diffusers UNet2DConditionModel config -> UNet22 kwargs;
    ``num_image_tokens`` (from the weights) wins over the config's."""
    out = dict(
        in_channels=cfg["in_channels"],
        out_channels=cfg["out_channels"],
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg["layers_per_block"],
        attention_head_dim=cfg["attention_head_dim"],
        cross_attention_dim=cfg["cross_attention_dim"],
        encoder_hid_dim=cfg["encoder_hid_dim"],
        down_block_types=tuple(cfg["down_block_types"]),
        up_block_types=tuple(cfg["up_block_types"]),
        eps=cfg.get("norm_eps", 1e-5),
        controlnet_hint=cfg.get("addition_embed_type") == "image_hint",
    )
    if num_image_tokens is not None:
        out["num_image_tokens"] = num_image_tokens
    elif "num_image_tokens" in cfg:
        out["num_image_tokens"] = cfg["num_image_tokens"]
    return out


def prior22_overrides(cfg: dict) -> dict:
    """diffusers PriorTransformer config -> PriorTransformer22 kwargs."""
    out = dict(
        num_attention_heads=cfg["num_attention_heads"],
        attention_head_dim=cfg["attention_head_dim"],
        num_layers=cfg["num_layers"],
        embedding_dim=cfg["embedding_dim"],
        num_embeddings=cfg["num_embeddings"],
        additional_embeddings=cfg["additional_embeddings"],
    )
    if "embedding_order" in cfg:
        out["embedding_order"] = tuple(cfg["embedding_order"])
    return out


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
    """HF CLIPTextConfig -> HFCLIPText kwargs.  Some exports carry the
    generic ``eos_token_id`` 2; CLIP BPE's end-of-text id, where the tower
    pools, is ``vocab_size - 1``."""
    eot = cfg.get("eos_token_id", 49407)
    if eot == 2:
        eot = cfg["vocab_size"] - 1
    return dict(
        vocab_size=cfg["vocab_size"],
        context_length=cfg["max_position_embeddings"],
        hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"],
        intermediate=cfg["intermediate_size"],
        projection_dim=cfg["projection_dim"],
        act=cfg.get("hidden_act", "gelu"),
        eps=cfg.get("layer_norm_eps", 1e-5),
        eot_token_id=eot,
    )


def clip_vision_overrides(cfg: dict) -> dict:
    """HF CLIPVisionConfig -> HFCLIPVision kwargs: ``hidden_act``
    "quick_gelu" is QuickGELU, anything else the exact, erf GELU (the
    published tower's)."""
    from ..models.text_encoders import exact_gelu, quick_gelu

    act = quick_gelu if cfg.get("hidden_act") == "quick_gelu" else exact_gelu
    return dict(
        image_size=cfg["image_size"],
        patch_size=cfg["patch_size"],
        hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"],
        intermediate=cfg["intermediate_size"],
        projection_dim=cfg["projection_dim"],
        act=act,
        eps=cfg.get("layer_norm_eps", 1e-5),
    )


def derive_num_image_tokens(sd: dict, cross_attention_dim: int) -> Optional[int]:
    """The ImageProjection token count of a UNet checkpoint:
    ``encoder_hid_proj.image_embeds.weight`` is [num_tokens ·
    cross_attention_dim, encoder_hid_dim].  None where the key is absent."""
    for key in ("encoder_hid_proj.image_embeds.weight",
                "encoder_hid_proj.image_projection.weight"):
        if key in sd:
            rows = sd[key].shape[0]
            if rows % cross_attention_dim:
                raise ValueError(f"{key} rows={rows} not divisible by "
                                 f"cross_attention_dim={cross_attention_dim}")
            return rows // cross_attention_dim
    return None


def pipeline_overrides(prior_dir: Optional[str] = None,
                       decoder_dir: Optional[str] = None,
                       task_type: str = "text2img",
                       unet_sd: Optional[dict] = None) -> dict:
    """The ``overrides`` dict of ``pipelines.Kandinsky2_2`` for
    ``task_type`` from the snapshots' configs (the vendored ones where a
    directory is None or lacks a config).  ``unet_sd``, when given, grounds
    ``num_image_tokens`` in the weights' shapes."""
    unet_cfg = load_model_config(decoder_dir, "unet", _UNET_FIXTURE[task_type])
    n_tokens = None
    if unet_sd is not None:
        n_tokens = derive_num_image_tokens(unet_sd, unet_cfg["cross_attention_dim"])
    return {
        "unet": unet22_overrides(unet_cfg, num_image_tokens=n_tokens),
        "movq": movq22_overrides(load_model_config(decoder_dir, "movq", "decoder__movq")),
        "prior": prior22_overrides(load_model_config(prior_dir, "prior", "prior__prior")),
        "text_encoder": clip_text_overrides(
            load_model_config(prior_dir, "text_encoder", "prior__text_encoder")),
        "image_encoder": clip_vision_overrides(
            load_model_config(prior_dir, "image_encoder", "prior__image_encoder")),
    }
