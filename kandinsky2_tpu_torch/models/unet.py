"""ADM-style latent UNet, NHWC, the counterpart of
``kandinsky2_tpu/models/unet.py``: ``ResBlock``, ``AttentionBlock``,
``Downsample``, ``Upsample``, the ``UNetModel`` torso and the 2.1 text+image
conditioned ``Text2ImUNet21`` with its ``encode_conditioning`` / ``denoise``
split.

Every GroupNorm runs the GroupNorm kernel pair, and the spatial attention
(encoder K/V prepended to the spatial K/V, so S = T + tokens) runs the
flash-attention kernel, on a CUDA tensor.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import qkv_attention
from .layers import (
    Conv2d,
    GroupNorm32,
    LayerNormF32,
    Linear,
    avg_pool_2x,
    timestep_embedding,
    upsample_nearest_2x,
)


class ResBlock(nn.Module):
    """Residual block with FiLM scale-shift GroupNorm (unet.py:110-220)."""

    def __init__(self, channels, out_channels, emb_channels,
                 use_scale_shift_norm=True, up=False, down=False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.up, self.down = up, down
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.ModuleList([
            GroupNorm32(channels, swish=1.0, device=device),
            nn.Identity(),
            Conv2d(channels, out_channels, dtype=dtype, device=device),
        ])
        emb_dim = 2 * out_channels if use_scale_shift_norm else out_channels
        self.emb_layers = nn.ModuleList([
            nn.SiLU(), Linear(emb_channels, emb_dim, dtype=dtype, device=device),
        ])
        self.out_layers = nn.ModuleList([
            GroupNorm32(out_channels, swish=1.0, device=device),
            nn.Identity(),
            nn.Identity(),
            Conv2d(out_channels, out_channels, dtype=dtype, device=device),
        ])
        self.skip_connection = (
            Linear(channels, out_channels, dtype=dtype, device=device)
            if out_channels != channels else None
        )

    def forward(self, x, emb):
        h = self.in_layers[0](x)
        if self.up:
            x = upsample_nearest_2x(x)
            h = upsample_nearest_2x(h)
        elif self.down:
            h = avg_pool_2x(h)
            x = avg_pool_2x(x)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers[1](F.silu(emb)).to(h.dtype)[:, None, None, :]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = self.out_layers[0](h, film=(scale, shift))
        else:
            h = self.out_layers[0](h + emb_out)
        h = self.out_layers[3](h)
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h


class AttentionBlock(nn.Module):
    """Spatial self-attention with the encoder K/V concatenated before the
    spatial K/V (unet.py:223-340); per-head [q|k|v] channel layout."""

    def __init__(self, channels, num_heads, encoder_channels,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels, device=device)
        self.qkv = Linear(channels, 3 * channels, dtype=dtype, device=device)
        self.encoder_kv = Linear(encoder_channels, 2 * channels, dtype=dtype,
                                 device=device)
        self.proj_out = Linear(channels, channels, dtype=dtype, device=device)

    def forward(self, x, encoder_out):
        B, H, W, C = x.shape
        heads = self.num_heads
        ch = C // heads
        h = self.norm(x).reshape(B, H * W, C)
        q, k, v = self.qkv(h).reshape(B, H * W, heads, 3 * ch).split(ch, dim=-1)
        ekv = self.encoder_kv(encoder_out).reshape(
            B, encoder_out.shape[1], heads, 2 * ch
        )
        ek, ev = ekv.split(ch, dim=-1)
        k = torch.cat([ek, k], dim=1)
        v = torch.cat([ev, v], dim=1)
        a = qkv_attention(q, k, v).reshape(B, H * W, C)
        return x + self.proj_out(a).reshape(B, H, W, C)


class Downsample(nn.Module):
    """Strided-conv downsample (unet.py:80-107)."""

    def __init__(self, channels, out_channels, dtype=torch.float32, device=None):
        super().__init__()
        self.op = Conv2d(channels, out_channels, stride=2, dtype=dtype,
                         device=device)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2x + 3x3 conv (unet.py:48-77)."""

    def __init__(self, channels, out_channels, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(channels, out_channels, dtype=dtype, device=device)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


def _build_plan(model_channels: int, num_res_blocks: int,
                channel_mult: Sequence[int],
                attention_resolutions: Sequence[int], resblock_updown: bool):
    """Static layer plan mirroring the torch constructor's channel/ds
    bookkeeping (unet.py:424-557): lists of (kind, in_ch, out_ch) per
    TimestepEmbedSequential."""
    ch = int(channel_mult[0] * model_channels)
    input_plan = [[("conv_in", 0, ch)]]
    input_chans = [ch]
    ds = 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            layers = [("res", ch, int(mult * model_channels))]
            ch = int(mult * model_channels)
            if ds in attention_resolutions:
                layers.append(("attn", ch, ch))
            input_plan.append(layers)
            input_chans.append(ch)
        if level != len(channel_mult) - 1:
            input_plan.append([("res_down" if resblock_updown else "down", ch, ch)])
            input_chans.append(ch)
            ds *= 2
    middle_ch = ch
    output_plan = []
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks + 1):
            ich = input_chans.pop()
            layers = [("res", ch + ich, int(model_channels * mult))]
            ch = int(model_channels * mult)
            if ds in attention_resolutions:
                layers.append(("attn", ch, ch))
            if level and i == num_res_blocks:
                layers.append(("res_up" if resblock_updown else "up", ch, ch))
                ds //= 2
            output_plan.append(layers)
    return input_plan, middle_ch, output_plan


class UNetModel(nn.Module):
    """UNet torso + timestep embedding (unet.py:343-611)."""

    def __init__(self, in_channels=4, model_channels=384, out_channels=8,
                 num_res_blocks=3, attention_resolutions=(2, 4, 8),
                 channel_mult=(1, 2, 3, 4), num_heads=1, num_head_channels=64,
                 num_heads_upsample=-1, use_scale_shift_norm=True,
                 resblock_updown=True, encoder_channels=768,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.model_channels = model_channels
        self.num_head_channels = num_head_channels
        self.num_heads = num_heads
        self.num_heads_upsample = num_heads_upsample
        emb_ch = model_channels * 4
        input_plan, middle_ch, output_plan = _build_plan(
            model_channels, num_res_blocks, tuple(channel_mult),
            tuple(attention_resolutions), resblock_updown,
        )

        def make(spec, upsample_branch):
            kind, cin, cout = spec
            if kind == "conv_in":
                return Conv2d(in_channels, cout, dtype=dtype, device=device)
            if kind in ("res", "res_down", "res_up"):
                return ResBlock(cin, cout, emb_ch, use_scale_shift_norm,
                                up=kind == "res_up", down=kind == "res_down",
                                dtype=dtype, device=device)
            if kind == "attn":
                return AttentionBlock(cout, self._heads(cout, upsample_branch),
                                      encoder_channels, dtype=dtype,
                                      device=device)
            if kind == "down":
                return Downsample(cin, cout, dtype=dtype, device=device)
            if kind == "up":
                return Upsample(cin, cout, dtype=dtype, device=device)
            raise ValueError(kind)

        self.input_blocks = nn.ModuleList(
            nn.ModuleList(make(s, False) for s in layers) for layers in input_plan
        )
        self.middle_block = nn.ModuleList(
            make(s, False) for s in [
                ("res", middle_ch, middle_ch),
                ("attn", middle_ch, middle_ch),
                ("res", middle_ch, middle_ch),
            ]
        )
        self.output_blocks = nn.ModuleList(
            nn.ModuleList(make(s, True) for s in layers) for layers in output_plan
        )
        # the output head stays fp32 (unet.py:559-572)
        self.out = nn.ModuleList([
            GroupNorm32(output_plan[-1][-1][2], swish=1.0, device=device),
            nn.Identity(),
            Conv2d(output_plan[-1][-1][2], out_channels, dtype=torch.float32,
                   device=device),
        ])
        self.time_embed = nn.ModuleList([
            Linear(model_channels, emb_ch, device=device),
            nn.SiLU(),
            Linear(emb_ch, emb_ch, device=device),
        ])

    def _heads(self, ch: int, upsample: bool) -> int:
        if self.num_head_channels != -1:
            return ch // self.num_head_channels
        if upsample and self.num_heads_upsample != -1:
            return self.num_heads_upsample
        return self.num_heads

    @staticmethod
    def _run_layer(layer, h, emb, encoder_out):
        if isinstance(layer, ResBlock):
            return layer(h, emb)
        if isinstance(layer, AttentionBlock):
            return layer(h, encoder_out)
        return layer(h)

    def run_torso(self, x, emb, encoder_out=None):
        h = x.to(self.dtype)
        hs = []
        for layers in self.input_blocks:
            for layer in layers:
                h = self._run_layer(layer, h, emb, encoder_out)
            hs.append(h)
        for layer in self.middle_block:
            h = self._run_layer(layer, h, emb, encoder_out)
        for layers in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=-1)
            for layer in layers:
                h = self._run_layer(layer, h, emb, encoder_out)
        return self.out[2](self.out[0](h.float()))

    def time_embedding(self, timesteps):
        temb = timestep_embedding(timesteps, self.model_channels)
        return self.time_embed[2](F.silu(self.time_embed[0](temb)))


class Text2ImUNet21(UNetModel):
    """Kandinsky 2.1 conditioned UNet (text2im_model2_1.py:13-129): the CLIP
    image embedding becomes ``num_image_embs`` tokens prepended to the
    projected XLM-R tokens as cross-attention K/V; the pooled text and image
    embeddings add to the timestep embedding."""

    def __init__(self, model_dim=768, image_encoder_in_dim=768,
                 text_encoder_in_dim1=1024, text_encoder_in_dim2=768,
                 num_image_embs=10, dtype=torch.float32, device=None, **kw):
        super().__init__(encoder_channels=model_dim, dtype=dtype, device=device,
                         **kw)
        mc4 = self.model_channels * 4
        self.model_dim = model_dim
        self.num_image_embs = num_image_embs
        self.clip_to_seq = Linear(image_encoder_in_dim, model_dim * num_image_embs,
                                  dtype=dtype, device=device)
        self.to_model_dim_n = Linear(text_encoder_in_dim1, model_dim, dtype=dtype,
                                     device=device)
        self.proj_n = Linear(text_encoder_in_dim2, mc4, dtype=dtype, device=device)
        self.ln_model_n = LayerNormF32(mc4, device=device)
        self.img_layer = Linear(image_encoder_in_dim, mc4, dtype=dtype,
                                device=device)

    def encode_conditioning(self, full_emb, pooled_emb, image_emb):
        """(xf_proj, xf_out): the time-embedding addend and the
        cross-attention tokens (text2im_model2_1.py:57-80), once per call."""
        B = image_emb.shape[0]
        clip_seq = self.clip_to_seq(image_emb).reshape(
            B, self.num_image_embs, self.model_dim
        )
        xf_proj = self.ln_model_n(self.proj_n(pooled_emb))
        xf_proj = xf_proj + self.img_layer(image_emb)
        xf_out = torch.cat([clip_seq, self.to_model_dim_n(full_emb)], dim=1)
        return xf_proj, xf_out

    def denoise(self, x, timesteps, xf_proj, xf_out):
        emb = self.time_embedding(timesteps) + xf_proj.float()
        return self.run_torso(x, emb, xf_out)

    def forward(self, x, timesteps, full_emb, pooled_emb, image_emb):
        xf_proj, xf_out = self.encode_conditioning(full_emb, pooled_emb, image_emb)
        return self.denoise(x, timesteps, xf_proj, xf_out)
