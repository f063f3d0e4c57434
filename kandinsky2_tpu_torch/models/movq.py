"""MoVQ decoder, NHWC, the counterpart of the decode half of
``kandinsky2_tpu/models/movq.py``: ``SpatialNorm``, ``ResnetBlock``,
``AttnBlock``, ``Upsample``, the spatially-normalised ``Decoder`` and
``MOVQ.decode`` with ``post_quant_conv``.  The encoder and the quantizer are
not ported yet.

Every norm runs the GroupNorm kernel pair, and the single-head d = 512
``AttnBlock`` runs the flash-attention kernel, on a CUDA tensor.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from .layers import (
    Container,
    Conv2d,
    GroupNorm32,
    Linear,
    resize_nearest,
    upsample_nearest_2x,
)


class SpatialNorm(nn.Module):
    """norm(f) · conv_y(zq) + conv_b(zq), zq nearest-resized to f
    (movq_modules.py:34-68).  The 1x1 convs run at zq's resolution and their
    outputs are resized, which is the same function."""

    def __init__(self, f_channels, zq_channels, dtype=torch.float32, device=None):
        super().__init__()
        self.norm_layer = GroupNorm32(f_channels, eps=1e-6, device=device)
        self.conv_y = Linear(zq_channels, f_channels, dtype=dtype, device=device)
        self.conv_b = Linear(zq_channels, f_channels, dtype=dtype, device=device)

    def forward(self, f, zq):
        size = f.shape[1:3]
        return (self.norm_layer(f) * resize_nearest(self.conv_y(zq), size)
                + resize_nearest(self.conv_b(zq), size))


class ResnetBlock(nn.Module):
    """movq_modules.ResnetBlock:120 (no timestep embedding)."""

    def __init__(self, in_channels, out_channels, zq_channels,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.norm1 = SpatialNorm(in_channels, zq_channels, dtype, device)
        self.conv1 = Conv2d(in_channels, out_channels, dtype=dtype, device=device)
        self.norm2 = SpatialNorm(out_channels, zq_channels, dtype, device)
        self.conv2 = Conv2d(out_channels, out_channels, dtype=dtype, device=device)
        self.nin_shortcut = (
            Linear(in_channels, out_channels, dtype=dtype, device=device)
            if in_channels != out_channels else None
        )

    def forward(self, x, zq):
        h = self.conv1(F.silu(self.norm1(x, zq)))
        h = self.conv2(F.silu(self.norm2(h, zq)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full spatial self-attention (movq_modules.py:182-225),
    through the flash-attention kernel with d = C."""

    def __init__(self, channels, zq_channels, dtype=torch.float32, device=None):
        super().__init__()
        self.norm = SpatialNorm(channels, zq_channels, dtype, device)
        self.q = Linear(channels, channels, dtype=dtype, device=device)
        self.k = Linear(channels, channels, dtype=dtype, device=device)
        self.v = Linear(channels, channels, dtype=dtype, device=device)
        self.proj_out = Linear(channels, channels, dtype=dtype, device=device)

    def forward(self, x, zq):
        B, H, W, C = x.shape
        h = self.norm(x, zq)
        q, k, v = (lin(h).reshape(B, H * W, 1, C) for lin in (self.q, self.k, self.v))
        out = flash_attention(q, k, v)[0].reshape(B, H, W, C)
        return x + self.proj_out(out)


class Upsample(nn.Module):
    """Nearest 2x + 3x3 conv (vqgan_blocks.py:93-106)."""

    def __init__(self, channels, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, dtype=dtype, device=device)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class Decoder(nn.Module):
    """MOVQDecoder (movq_modules.py:228-357): every norm a SpatialNorm."""

    def __init__(self, ch=128, out_ch=3, ch_mult: Sequence[int] = (1, 2, 2, 4),
                 num_res_blocks=2, attn_resolutions: Sequence[int] = (32,),
                 resolution=256, z_channels=4, zq_channels=4,
                 dtype=torch.float32, device=None):
        super().__init__()
        num_res = len(ch_mult)
        kw = dict(dtype=dtype, device=device)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (num_res - 1)
        self.conv_in = Conv2d(z_channels, block_in, **kw)
        self.mid = Container(
            block_1=ResnetBlock(block_in, block_in, zq_channels, **kw),
            attn_1=AttnBlock(block_in, zq_channels, **kw),
            block_2=ResnetBlock(block_in, block_in, zq_channels, **kw),
        )
        levels = {}
        for i_level in reversed(range(num_res)):
            block_out = ch * ch_mult[i_level]
            blocks, attns = nn.ModuleList(), nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out, zq_channels, **kw))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in, zq_channels, **kw))
            level = Container(block=blocks, attn=attns)
            if i_level != 0:
                level.upsample = Upsample(block_in, **kw)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList(levels[i] for i in range(num_res))
        self.norm_out = SpatialNorm(block_in, zq_channels, **kw)
        self.conv_out = Conv2d(block_in, out_ch, **kw)

    def forward(self, z, zq):
        h = self.conv_in(z)
        h = self.mid.block_1(h, zq)
        h = self.mid.attn_1(h, zq)
        h = self.mid.block_2(h, zq)
        for level in reversed(self.up):
            for i, block in enumerate(level.block):
                h = block(h, zq)
                if len(level.attn):
                    h = level.attn[i](h, zq)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        h = F.silu(self.norm_out(h, zq))
        return self.conv_out(h)


class MOVQ(nn.Module):
    """MoVQ facade (autoencoder.py:160-201), decode half: the latent itself
    modulates the decoder."""

    def __init__(self, z_channels=4, embed_dim=4, ch=128,
                 ch_mult: Sequence[int] = (1, 2, 2, 4), num_res_blocks=2,
                 attn_resolutions: Sequence[int] = (32,), resolution=256,
                 out_ch=3, dtype=torch.float32, device=None):
        super().__init__()
        self.decoder = Decoder(
            ch=ch, out_ch=out_ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
            attn_resolutions=attn_resolutions, resolution=resolution,
            z_channels=z_channels, zq_channels=embed_dim, dtype=dtype,
            device=device,
        )
        self.post_quant_conv = Linear(embed_dim, z_channels, dtype=dtype,
                                      device=device)

    def decode(self, quant):
        return self.decoder(self.post_quant_conv(quant), quant)
