"""The MoVQ codec of 2.1 and 2.2, NHWC, fp32: the conv encoder (plain
GroupNorms) and the decoder whose norms are spatially modulated by the
latent (SpatialNorm); single-head attention at the lowest level."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .layers import Container, Conv2d, GroupNorm32, Linear, attention, upsample_nearest_2x


class SpatialNorm(nn.Module):
    """norm(f) · conv_y(zq) + conv_b(zq), zq nearest-resized to f."""

    def __init__(self, f_channels, zq_channels, device=None):
        super().__init__()
        self.norm_layer = GroupNorm32(f_channels, eps=1e-6, device=device)
        self.conv_y = Linear(zq_channels, f_channels, device=device)
        self.conv_b = Linear(zq_channels, f_channels, device=device)

    def forward(self, f, zq):
        B, H, W, C = f.shape
        hz, wz = zq.shape[1:3]
        n = self.norm_layer(f).reshape(B, hz, H // hz, wz, W // wz, C)
        y, b = (conv(zq)[:, :, None, :, None] for conv in (self.conv_y, self.conv_b))
        return (n * y + b).reshape(B, H, W, C)


def _norm(channels, zq_channels, device):
    if zq_channels is None:
        return GroupNorm32(channels, eps=1e-6, device=device)
    return SpatialNorm(channels, zq_channels, device)


def _apply(norm, x, zq):
    return norm(x) if zq is None else norm(x, zq)


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, zq_channels=None, device=None):
        super().__init__()
        self.norm1 = _norm(cin, zq_channels, device)
        self.conv1 = Conv2d(cin, cout, device=device)
        self.norm2 = _norm(cout, zq_channels, device)
        self.conv2 = Conv2d(cout, cout, device=device)
        self.nin_shortcut = Linear(cin, cout, device=device) if cin != cout else None

    def forward(self, x, zq=None):
        h = self.conv1(F.silu(_apply(self.norm1, x, zq)))
        h = self.conv2(F.silu(_apply(self.norm2, h, zq)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, channels, zq_channels=None, device=None):
        super().__init__()
        self.norm = _norm(channels, zq_channels, device)
        self.q = Linear(channels, channels, device=device)
        self.k = Linear(channels, channels, device=device)
        self.v = Linear(channels, channels, device=device)
        self.proj_out = Linear(channels, channels, device=device)

    def forward(self, x, zq=None):
        B, H, W, C = x.shape
        h = _apply(self.norm, x, zq)
        q, k, v = (lin(h).reshape(B, H * W, 1, C) for lin in (self.q, self.k, self.v))
        return x + self.proj_out(attention(q, k, v).reshape(B, H, W, C))


class Downsample(nn.Module):
    """One zero row and column at the bottom and right, a 3x3 conv of stride 2."""

    def __init__(self, channels, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, stride=2, padding=0, device=device)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, device=device)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class Decoder(nn.Module):
    def __init__(self, ch, out_ch, ch_mult, num_res_blocks, attn_resolutions, resolution,
                 z_channels, zq_channels, device=None):
        super().__init__()
        n = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (n - 1)
        self.conv_in = Conv2d(z_channels, block_in, device=device)
        self.mid = Container(block_1=ResnetBlock(block_in, block_in, zq_channels, device),
                             attn_1=AttnBlock(block_in, zq_channels, device),
                             block_2=ResnetBlock(block_in, block_in, zq_channels, device))
        levels = {}
        for i_level in reversed(range(n)):
            block_out = ch * ch_mult[i_level]
            blocks, attns = nn.ModuleList(), nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out, zq_channels, device))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in, zq_channels, device))
            level = Container(block=blocks, attn=attns)
            if i_level != 0:
                level.upsample = Upsample(block_in, device)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList(levels[i] for i in range(n))
        self.norm_out = _norm(block_in, zq_channels, device)
        self.conv_out = Conv2d(block_in, out_ch, device=device)

    def forward(self, z, zq):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h, zq), zq), zq)
        for level in reversed(self.up):
            for i, block in enumerate(level.block):
                h = block(h, zq)
                if len(level.attn):
                    h = level.attn[i](h, zq)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(_apply(self.norm_out, h, zq)))


class Encoder(nn.Module):
    def __init__(self, ch, ch_mult, num_res_blocks, attn_resolutions, resolution,
                 in_channels, z_channels, device=None):
        super().__init__()
        in_ch_mult = (1,) + tuple(ch_mult)
        self.conv_in = Conv2d(in_channels, ch, device=device)
        curr_res = resolution
        self.down = nn.ModuleList()
        for i_level, mult in enumerate(ch_mult):
            block_in, block_out = ch * in_ch_mult[i_level], ch * mult
            blocks, attns = nn.ModuleList(), nn.ModuleList()
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(block_in, block_out, device=device))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in, device=device))
            level = Container(block=blocks, attn=attns)
            if i_level != len(ch_mult) - 1:
                level.downsample = Downsample(block_in, device)
                curr_res //= 2
            self.down.append(level)
        self.mid = Container(block_1=ResnetBlock(block_in, block_in, device=device),
                             attn_1=AttnBlock(block_in, device=device),
                             block_2=ResnetBlock(block_in, block_in, device=device))
        self.norm_out = GroupNorm32(block_in, eps=1e-6, device=device)
        self.conv_out = Conv2d(block_in, z_channels, device=device)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for i, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class MOVQ(nn.Module):
    """``encode``: the pre-quantisation latent; ``decode``: the decoder
    modulated by the latent itself."""

    def __init__(self, z_channels, embed_dim, n_embed, ch, ch_mult, num_res_blocks,
                 attn_resolutions, resolution, in_channels, out_ch, device=None):
        super().__init__()
        self.decoder = Decoder(ch, out_ch, ch_mult, num_res_blocks, attn_resolutions,
                               resolution, z_channels, embed_dim, device)
        self.post_quant_conv = Linear(embed_dim, z_channels, device=device)
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, attn_resolutions, resolution,
                               in_channels, z_channels, device)
        self.quantize = Container(embedding=nn.Embedding(n_embed, embed_dim, device=device))
        self.quant_conv = Linear(z_channels, embed_dim, device=device)

    def encode(self, x):
        return self.quant_conv(self.encoder(x))

    def decode(self, quant):
        return self.decoder(self.post_quant_conv(quant), quant)


def movq_kwargs(cfg: dict) -> dict:
    """MOVQ's arguments from a diffusers VQModel config: an Attn block at
    level i of the 256-px ladder attends at 256 / 2**i."""
    ch0 = cfg["block_out_channels"][0]
    return dict(
        z_channels=cfg["latent_channels"], embed_dim=cfg["vq_embed_dim"],
        n_embed=cfg["num_vq_embeddings"], ch=ch0,
        ch_mult=tuple(c // ch0 for c in cfg["block_out_channels"]),
        num_res_blocks=cfg["layers_per_block"],
        attn_resolutions=tuple(256 // 2 ** i for i, t in enumerate(cfg["down_block_types"])
                               if "Attn" in t),
        resolution=256, in_channels=cfg["in_channels"], out_ch=cfg["out_channels"])
