"""The reference models of each configuration, built from its file's
published widths."""

from __future__ import annotations

import torch.nn.functional as F

from .encoders import CLIPViT, HFCLIPText, HFCLIPVision, TextEncoder, quick_gelu
from .movq import MOVQ, movq_kwargs
from .prior22 import PriorTransformer22
from .unet21 import Text2ImUNet21, unet21_kwargs
from .unet22 import UNet22


def _act(cfg):
    return quick_gelu if cfg.get("hidden_act") == "quick_gelu" else F.gelu


def build22(cfg: dict, device=None) -> dict:
    """The five models of Kandinsky 2.2 from the diffusers/HF configs."""
    te, ie, pr, un = cfg["text_encoder"], cfg["image_encoder"], cfg["prior"], cfg["unet"]
    return {
        "image_encoder": HFCLIPVision(
            ie["image_size"], ie["patch_size"], ie["hidden_size"], ie["num_hidden_layers"],
            ie["num_attention_heads"], ie["intermediate_size"], ie["projection_dim"],
            _act(ie), ie["layer_norm_eps"], device),
        "text_encoder": HFCLIPText(
            te["vocab_size"], te["max_position_embeddings"], te["hidden_size"],
            te["num_hidden_layers"], te["num_attention_heads"], te["intermediate_size"],
            te["projection_dim"], te["eos_token_id"], _act(te), te["layer_norm_eps"], device),
        "prior": PriorTransformer22(
            pr["num_attention_heads"], pr["attention_head_dim"], pr["num_layers"],
            pr["embedding_dim"], pr["num_embeddings"], pr["additional_embeddings"], device),
        "unet": UNet22(
            un["in_channels"], un["out_channels"], tuple(un["block_out_channels"]),
            un["layers_per_block"], un["attention_head_dim"], un["cross_attention_dim"],
            un["encoder_hid_dim"], cfg["num_image_tokens"], tuple(un["down_block_types"]),
            tuple(un["up_block_types"]), un["norm_eps"], device),
        "movq": MOVQ(**movq_kwargs(cfg["movq"]), device=device),
    }


def build21(cfg: dict, device=None) -> dict:
    """The models of the 2.1 decoder's training step: the UNet and the
    frozen MoVQ, XLM-R/MCLIP text encoder and CLIP ViT image tower."""
    ie, te, cv = cfg["image_enc_params"], cfg["text_enc_params"], cfg["clip_vision_params"]
    dd = ie["params"]["ddconfig"]
    return {
        "unet": Text2ImUNet21(**unet21_kwargs(cfg["model_config"]), device=device),
        "movq": MOVQ(z_channels=dd["z_channels"], embed_dim=ie["params"]["embed_dim"],
                     n_embed=ie["params"]["n_embed"], ch=dd["ch"], ch_mult=tuple(dd["ch_mult"]),
                     num_res_blocks=dd["num_res_blocks"],
                     attn_resolutions=tuple(dd["attn_resolutions"]),
                     resolution=dd["resolution"], in_channels=dd["in_channels"],
                     out_ch=dd["out_ch"], device=device),
        "text_encoder": TextEncoder(te["in_features"], te["out_features"], te["layers"],
                                    te["heads"], te["intermediate"], te["vocab_size"],
                                    te["max_positions"], device),
        "clip_vision": CLIPViT(cv["image_size"], cv["patch_size"], cv["width"], cv["layers"],
                               cv["heads"], cv["embed_dim"], device),
    }
