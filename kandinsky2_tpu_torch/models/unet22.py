"""Kandinsky 2.2 decoder UNet (the diffusers ``UNet2DConditionModel`` layout
of kandinsky-community/kandinsky-2-2-decoder), NHWC, the counterpart of
``kandinsky2_tpu/models/unet22.py``.

An unCLIP-style UNet conditioned only on a 1280-d image embedding: block
channels (384, 768, 1280, 1536), three resnets a level with scale-shift
time conditioning and resblock up/downsampling, and ``AddedKVAttention``
after each resnet of levels 1-3 and in the middle (the image embedding's
``num_image_tokens`` pseudo-tokens projected by add_k/add_v and prepended
to the spatial K/V).  The ControlNet-depth variant encodes a pixel-space
hint into 4 latent channels concatenated to the sample.

Every GroupNorm runs the GroupNorm kernel pair on a CUDA tensor, and the
added-KV attention the flash-attention kernel K3 where
``ops.attention.use_flash_kernel`` sends it (bf16, d = 64).  Submodules
carry the diffusers state_dict names (``down_blocks.{i}.resnets.{j}``,
``mid_block.attentions.0.to_out.0``, ``add_embedding.input_hint_block.14``),
the JAX package's parameter paths.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import added_kv_attention
from .layers import (
    Container,
    Conv2d,
    GroupNorm32,
    LayerNormF32,
    Linear,
    avg_pool_2x,
    upsample_nearest_2x,
)

# the ControlNet hint stack's conv widths; convs 2, 4 and 6 have stride 2
HINT_CHANNELS = (16, 16, 32, 32, 96, 96, 256)


def timestep_embedding_22(timesteps: torch.Tensor, dim: int,
                          max_period: float = 10000.0) -> torch.Tensor:
    """diffusers get_timestep_embedding with flip_sin_to_cos=False and
    downscale_freq_shift=0: [sin, cos] order (2.0 and 2.1 use [cos, sin]);
    fp32 output."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class ResnetBlock22(nn.Module):
    """diffusers ResnetBlock2D with time_scale_shift "scale_shift" (the FiLM
    folded into norm2) and an optional internal up (nearest 2x, then conv1)
    or down (2x2 average pool) step."""

    def __init__(self, in_channels, out_channels, temb_channels, up=False,
                 down=False, eps=1e-5, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.up, self.down = up, down
        self.norm1 = GroupNorm32(in_channels, eps=eps, swish=1.0, device=device)
        self.conv1 = Conv2d(in_channels, out_channels, **kw)
        self.time_emb_proj = Linear(temb_channels, 2 * out_channels, **kw)
        self.norm2 = GroupNorm32(out_channels, eps=eps, swish=1.0, device=device)
        self.conv2 = Conv2d(out_channels, out_channels, **kw)
        self.conv_shortcut = (Linear(in_channels, out_channels, **kw)
                              if in_channels != out_channels else None)

    def forward(self, x, temb):
        h = self.norm1(x)
        if self.up:
            x = upsample_nearest_2x(x)
            h = upsample_nearest_2x(h)
        elif self.down:
            h = avg_pool_2x(h)
            x = avg_pool_2x(x)
        h = self.conv1(h)
        emb = self.time_emb_proj(F.silu(temb)).to(h.dtype)[:, None, None, :]
        h = self.norm2(h, film=emb.chunk(2, dim=-1))
        h = self.conv2(h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AddedKVAttention(nn.Module):
    """diffusers Attention with AttnAddedKVProcessor: GroupNorm'd spatial
    tokens, separate q/k/v projections, and the encoder states' add_k/add_v
    projections prepended to the spatial K/V; one 1/√d scale and an fp32
    softmax (``ops.attention.added_kv_attention``)."""

    def __init__(self, channels, heads, cross_attention_dim, eps=1e-5,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.group_norm = GroupNorm32(channels, eps=eps, device=device)
        self.to_q = Linear(channels, channels, **kw)
        self.to_k = Linear(channels, channels, **kw)
        self.to_v = Linear(channels, channels, **kw)
        self.add_k_proj = Linear(cross_attention_dim, channels, **kw)
        self.add_v_proj = Linear(cross_attention_dim, channels, **kw)
        self.to_out = nn.ModuleList([Linear(channels, channels, **kw)])

    def forward(self, x, encoder_states):
        B, H, W, C = x.shape
        heads = (B, -1, self.heads, C // self.heads)
        h = self.group_norm(x).reshape(B, H * W, C)
        q = self.to_q(h).reshape(heads)
        k = torch.cat([self.add_k_proj(encoder_states).reshape(heads),
                       self.to_k(h).reshape(heads)], dim=1)
        v = torch.cat([self.add_v_proj(encoder_states).reshape(heads),
                       self.to_v(h).reshape(heads)], dim=1)
        a = added_kv_attention(q, k, v).reshape(B, H * W, C)
        return x + self.to_out[0](a).reshape(B, H, W, C)


class ImageProjection(nn.Module):
    """Image embedding [B, D] -> ``num_image_text_embeds`` cross-attention
    tokens [B, N, cross_attention_dim] (diffusers ImageProjection: Linear,
    then LayerNorm)."""

    def __init__(self, in_dim, cross_attention_dim, num_image_text_embeds=10,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.shape = (num_image_text_embeds, cross_attention_dim)
        self.image_embeds = Linear(in_dim, num_image_text_embeds * cross_attention_dim,
                                   dtype=dtype, device=device)
        self.norm = LayerNormF32(cross_attention_dim, device=device)

    def forward(self, image_embeds):
        x = self.image_embeds(image_embeds)
        return self.norm(x.reshape(image_embeds.shape[0], *self.shape))


class ImageTimeEmbedding(nn.Module):
    """Image embedding -> the additive time-embedding term (diffusers
    ImageTimeEmbedding: Linear, then LayerNorm)."""

    def __init__(self, in_dim, time_embed_dim, dtype=torch.float32, device=None):
        super().__init__()
        self.image_proj = Linear(in_dim, time_embed_dim, dtype=dtype, device=device)
        self.image_norm = LayerNormF32(time_embed_dim, device=device)

    def forward(self, image_embeds):
        return self.image_norm(self.image_proj(image_embeds))


class ImageHintTimeEmbedding(ImageTimeEmbedding):
    """ControlNet variant (diffusers ImageHintTimeEmbedding): the image
    embedding's time term, and the pixel-space hint [B, H, W, 3] encoded by
    the conv stack (3 -> 16 -> 16 -> 32 -> 32 -> 96 -> 96 -> 256, SiLU after
    each, /8 spatially, then 256 -> 4) into a 4-channel latent map."""

    def __init__(self, in_dim, time_embed_dim, dtype=torch.float32, device=None):
        super().__init__(in_dim, time_embed_dim, dtype=dtype, device=device)
        convs, cin = {}, 3
        for i, c in enumerate(HINT_CHANNELS):
            convs[str(2 * i)] = Conv2d(cin, c, stride=2 if i in (2, 4, 6) else 1,
                                       dtype=dtype, device=device)
            cin = c
        convs[str(2 * len(HINT_CHANNELS))] = Conv2d(cin, 4, dtype=dtype, device=device)
        self.input_hint_block = Container(**convs)

    def forward(self, image_embeds, hint):
        h = hint
        *stack, last = self.input_hint_block.children()
        for conv in stack:
            h = F.silu(conv(h))
        return super().forward(image_embeds), last(h)


def deep_cache_spec22(unet) -> tuple[int, int]:
    """(spatial divisor, channels) of ``UNet22.denoise_cached``'s deep cache:
    the feature entering the last up block, at full resolution with
    ``block_out_channels[1]`` channels."""
    return 1, int(unet.block_out_channels[1])


class _Level(nn.Module):
    """One down or up block: ``resnets``, ``attentions`` after each resnet
    (a block type with "CrossAttn"), and a resampling resnet under
    ``downsamplers.0`` or ``upsamplers.0``."""

    def __init__(self, resnets, attentions, sampler_name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        self.sampler_name = sampler_name if sampler is not None else None
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))

    @property
    def sampler(self):
        return None if self.sampler_name is None else getattr(self, self.sampler_name)[0]

    def layers(self):
        """(resnet, attention or None) pairs, in order."""
        attns = list(getattr(self, "attentions", []))
        return [(r, attns[j] if j < len(attns) else None)
                for j, r in enumerate(self.resnets)]


class UNet22(nn.Module):
    """The Kandinsky 2.2 decoder UNet (the config of
    kandinsky-community/kandinsky-2-2-decoder by default)."""

    def __init__(
        self, in_channels=4, out_channels=8,
        block_out_channels: Sequence[int] = (384, 768, 1280, 1536),
        layers_per_block=3, attention_head_dim=64, cross_attention_dim=768,
        encoder_hid_dim=1280, num_image_tokens=10,
        down_block_types: Sequence[str] = (
            "ResnetDownsampleBlock2D", "SimpleCrossAttnDownBlock2D",
            "SimpleCrossAttnDownBlock2D", "SimpleCrossAttnDownBlock2D"),
        up_block_types: Sequence[str] = (
            "SimpleCrossAttnUpBlock2D", "SimpleCrossAttnUpBlock2D",
            "SimpleCrossAttnUpBlock2D", "ResnetUpsampleBlock2D"),
        controlnet_hint=False, eps=1e-5, dtype=torch.float32, device=None,
    ):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.in_channels = in_channels
        self.block_out_channels = tuple(block_out_channels)
        self.encoder_hid_dim = encoder_hid_dim
        self.controlnet_hint = controlnet_hint
        ch0 = block_out_channels[0]
        tdim = 4 * ch0
        self.time_embedding = Container(linear_1=Linear(ch0, tdim, **kw),
                                        linear_2=Linear(tdim, tdim, **kw))
        self.encoder_hid_proj = ImageProjection(encoder_hid_dim, cross_attention_dim,
                                                num_image_tokens, **kw)
        embedding = ImageHintTimeEmbedding if controlnet_hint else ImageTimeEmbedding
        self.add_embedding = embedding(encoder_hid_dim, tdim, **kw)
        self.conv_in = Conv2d(in_channels, ch0, **kw)

        def res(cin, cout, **extra):
            return ResnetBlock22(cin, cout, tdim, eps=eps, **extra, **kw)

        def attn(c):
            return AddedKVAttention(c, c // attention_head_dim, cross_attention_dim,
                                    eps=eps, **kw)

        n_levels = len(block_out_channels)
        skips, ch = [ch0], ch0
        down = []
        for i, out_ch in enumerate(block_out_channels):
            resnets, attns = [], []
            for _ in range(layers_per_block):
                resnets.append(res(ch, out_ch))
                ch = out_ch
                skips.append(ch)
                if "CrossAttn" in down_block_types[i]:
                    attns.append(attn(ch))
            sampler = None
            if i != n_levels - 1:
                sampler = res(ch, ch, down=True)
                skips.append(ch)
            down.append(_Level(resnets, attns, "downsamplers", sampler))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _Level([res(ch, ch), res(ch, ch)], [attn(ch)])
        up = []
        for i, out_ch in enumerate(reversed(block_out_channels)):
            resnets, attns = [], []
            for _ in range(layers_per_block + 1):
                resnets.append(res(ch + skips.pop(), out_ch))
                ch = out_ch
                if "CrossAttn" in up_block_types[i]:
                    attns.append(attn(ch))
            sampler = res(ch, ch, up=True) if i != n_levels - 1 else None
            up.append(_Level(resnets, attns, "upsamplers", sampler))
        self.up_blocks = nn.ModuleList(up)
        # the output head stays fp32, as the JAX package's
        self.conv_norm_out = GroupNorm32(ch, eps=eps, swish=1.0, device=device)
        self.conv_out = Conv2d(ch, out_channels, dtype=torch.float32, device=device)

    def encode_conditioning(self, image_embeds, hint=None):
        """(encoder_states, aug_emb, hint_latent), once per generation;
        ``hint`` [B, H, W, 3] for the ControlNet variant."""
        image_embeds = image_embeds.to(self.dtype)
        encoder_states = self.encoder_hid_proj(image_embeds)
        if self.controlnet_hint:
            aug_emb, hint_latent = self.add_embedding(image_embeds, hint.to(self.dtype))
            return encoder_states, aug_emb, hint_latent
        return encoder_states, self.add_embedding(image_embeds), None

    def embed_time(self, timesteps):
        """The time embedding (``time_embedding`` of the JAX module)."""
        temb = timestep_embedding_22(timesteps, self.block_out_channels[0])
        return self.time_embedding.linear_2(
            F.silu(self.time_embedding.linear_1(temb.to(self.dtype))))

    def denoise(self, x, timesteps, encoder_states, aug_emb, hint_latent=None):
        return self.denoise_cached(x, timesteps, encoder_states, aug_emb, hint_latent,
                                   None, True)[0]

    def denoise_cached(self, x, timesteps, encoder_states, aug_emb, hint_latent,
                       cache, refresh: bool):
        """DeepCache-style denoise: level 0 (conv_in, the first down block's
        resnets and the last up block) runs every call; everything deeper,
        from the first downsampler through the penultimate up block, runs
        only where ``refresh`` and is otherwise ``cache`` (shape
        ``deep_cache_spec22``).  Returns (out, new_cache); ``denoise`` is
        the call that always refreshes."""
        emb = self.embed_time(timesteps) + aug_emb.to(self.dtype)
        if self.controlnet_hint:
            x = torch.cat([x, hint_latent.to(x.dtype)], dim=-1)
        h = self.conv_in(x.to(self.dtype))
        hs = [h]

        def run(level, h, save=None, skips=None):
            for res, attn in level.layers():
                if skips is not None:
                    h = torch.cat([h, skips.pop()], dim=-1)
                h = res(h, emb)
                if attn is not None:
                    h = attn(h, encoder_states)
                if save is not None:
                    save.append(h)
            return h

        h = run(self.down_blocks[0], h, save=hs)
        if refresh:
            deep = []
            for i, level in enumerate(self.down_blocks):
                if i:
                    h = run(level, h, save=deep)
                if level.sampler is not None:
                    h = level.sampler(h, emb)
                    deep.append(h)
            # the middle block: resnet, attention, resnet
            h = run(self.mid_block, h)
            for level in self.up_blocks[:-1]:
                h = level.sampler(run(level, h, skips=deep), emb)
            h = h.to(self.dtype)
        else:
            h = cache.to(self.dtype)
        new_cache = h
        h = run(self.up_blocks[-1], h, skips=hs)
        return self.conv_out(self.conv_norm_out(h.float())), new_cache

    def forward(self, x, timesteps, image_embeds, hint=None):
        encoder_states, aug_emb, hint_latent = self.encode_conditioning(image_embeds,
                                                                        hint)
        return self.denoise(x, timesteps, encoder_states, aug_emb, hint_latent)
