"""The latent codecs, NHWC, the counterpart of ``kandinsky2_tpu/models/movq.py``:
``SpatialNorm``, ``ResnetBlock``, ``AttnBlock``, ``Downsample`` (asymmetric
pad), ``Upsample``, the conv ``Encoder`` (``double_z`` for the KL-VAE), the
``Decoder`` (spatially normalised for the MoVQ, plain for the KL-VAE and
the VQ codec), the ``VectorQuantizer`` and three facades: ``MOVQ`` (2.1 and
2.2), ``AutoencoderKL`` (2.0's KL-VAE: ``encode`` gives the posterior's
mean and clipped log-variance) and ``VQModelInterface``.

Every norm runs the GroupNorm kernel pair on a CUDA tensor, and the
single-head d = 512 ``AttnBlock`` the flash-attention kernel where
``ops.attention.use_flash_kernel`` sends it (bf16).  The encoders' blocks
norm with a plain GroupNorm(32, eps 1e-6), as the decoder's do where it has
no ``zq_channels``; the MoVQ decoder's with a ``SpatialNorm`` modulated by
the latent.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import qkv_attention
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


def _make_norm(channels, zq_channels, dtype, device):
    """GroupNorm(32, eps 1e-6) for the encoder (``zq_channels`` None), a
    SpatialNorm for the decoder (movq_modules.Normalize vs
    vqgan_blocks.Normalize)."""
    if zq_channels is None:
        return GroupNorm32(channels, eps=1e-6, device=device)
    return SpatialNorm(channels, zq_channels, dtype, device)


def _apply_norm(norm, x, zq):
    return norm(x) if zq is None else norm(x, zq)


class ResnetBlock(nn.Module):
    """vqgan_blocks.ResnetBlock:129 / movq_modules.ResnetBlock:120 (no
    timestep embedding); ``zq_channels`` None for the encoder's blocks."""

    def __init__(self, in_channels, out_channels, zq_channels=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.norm1 = _make_norm(in_channels, zq_channels, dtype, device)
        self.conv1 = Conv2d(in_channels, out_channels, dtype=dtype, device=device)
        self.norm2 = _make_norm(out_channels, zq_channels, dtype, device)
        self.conv2 = Conv2d(out_channels, out_channels, dtype=dtype, device=device)
        self.nin_shortcut = (
            Linear(in_channels, out_channels, dtype=dtype, device=device)
            if in_channels != out_channels else None
        )

    def forward(self, x, zq=None):
        h = self.conv1(F.silu(_apply_norm(self.norm1, x, zq)))
        h = self.conv2(F.silu(_apply_norm(self.norm2, h, zq)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full spatial self-attention (vqgan_blocks.py:196-239 /
    movq_modules.py:182-225): one head of d = C, routed by
    ``ops.attention.use_flash_kernel`` (the flash kernel in bf16 at
    d = 512)."""

    def __init__(self, channels, zq_channels=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.norm = _make_norm(channels, zq_channels, dtype, device)
        self.q = Linear(channels, channels, dtype=dtype, device=device)
        self.k = Linear(channels, channels, dtype=dtype, device=device)
        self.v = Linear(channels, channels, dtype=dtype, device=device)
        self.proj_out = Linear(channels, channels, dtype=dtype, device=device)

    def forward(self, x, zq=None):
        B, H, W, C = x.shape
        h = _apply_norm(self.norm, x, zq)
        q, k, v = (lin(h).reshape(B, H * W, 1, C) for lin in (self.q, self.k, self.v))
        out = qkv_attention(q, k, v).reshape(B, H, W, C)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Asymmetric-pad strided conv (vqgan_blocks.py:109-126): one zero row
    and column at the bottom and right, then a 3x3 conv of stride 2."""

    def __init__(self, channels, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, stride=2, padding=0, dtype=dtype,
                           device=device)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest 2x + 3x3 conv (vqgan_blocks.py:93-106)."""

    def __init__(self, channels, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, dtype=dtype, device=device)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class Decoder(nn.Module):
    """Conv decoder (vqgan_blocks.Decoder:370-499); with ``zq_channels`` the
    MOVQDecoder (movq_modules.py:228-357), every norm a SpatialNorm of the
    latent ``zq``; with ``zq_channels`` None every norm a GroupNorm."""

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
        self.norm_out = _make_norm(block_in, zq_channels, dtype, device)
        self.conv_out = Conv2d(block_in, out_ch, **kw)

    def forward(self, z, zq=None):
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
        h = F.silu(_apply_norm(self.norm_out, h, zq))
        return self.conv_out(h)


class Encoder(nn.Module):
    """Conv encoder (vqgan_blocks.Encoder:253-367); ``double_z`` doubles its
    output channels (the KL-VAE's mean and log-variance)."""

    def __init__(self, ch=128, ch_mult: Sequence[int] = (1, 2, 2, 4),
                 num_res_blocks=2, attn_resolutions: Sequence[int] = (32,),
                 resolution=256, in_channels=3, z_channels=4, double_z=False,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        in_ch_mult = (1,) + tuple(ch_mult)
        self.conv_in = Conv2d(in_channels, ch, **kw)
        curr_res = resolution
        self.down = nn.ModuleList()
        for i_level, mult in enumerate(ch_mult):
            block_in = ch * in_ch_mult[i_level]
            block_out = ch * mult
            blocks, attns = nn.ModuleList(), nn.ModuleList()
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(block_in, block_out, **kw))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in, **kw))
            level = Container(block=blocks, attn=attns)
            if i_level != len(ch_mult) - 1:
                level.downsample = Downsample(block_in, **kw)
                curr_res //= 2
            self.down.append(level)
        self.mid = Container(
            block_1=ResnetBlock(block_in, block_in, **kw),
            attn_1=AttnBlock(block_in, **kw),
            block_2=ResnetBlock(block_in, block_in, **kw),
        )
        self.norm_out = GroupNorm32(block_in, eps=1e-6, device=device)
        self.conv_out = Conv2d(block_in, 2 * z_channels if double_z else z_channels,
                               **kw)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for i, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_1(h)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VectorQuantizer(nn.Module):
    """L2 nearest-codebook lookup with the straight-through estimator
    (quntize.py:80-131)."""

    def __init__(self, n_e=16384, e_dim=4, device=None):
        super().__init__()
        self.e_dim = e_dim
        self.embedding = nn.Embedding(n_e, e_dim, device=device)

    def forward(self, z):
        """z NHWC with C = e_dim -> (z_q, indices [B, H, W]): argmin of
        |z|² + |e|² − 2 z·e in fp32."""
        emb = self.embedding.weight.float()
        flat = z.reshape(-1, self.e_dim).float()
        d = (flat.pow(2).sum(1, keepdim=True) + emb.pow(2).sum(1)[None]
             - 2.0 * flat @ emb.t())
        idx = torch.argmin(d, dim=1)
        z_q = emb[idx].reshape(z.shape).to(z.dtype)
        return z + (z_q - z).detach(), idx.reshape(z.shape[:-1])


class MOVQ(nn.Module):
    """MoVQ facade (autoencoder.py:160-201): ``encode`` returns the
    pre-quantisation latent (the 2.1 pipeline never quantises on encode,
    autoencoder.py:176-180); ``decode`` modulates the decoder with the
    latent itself."""

    def __init__(self, z_channels=4, embed_dim=4, n_embed=16384, ch=128,
                 ch_mult: Sequence[int] = (1, 2, 2, 4), num_res_blocks=2,
                 attn_resolutions: Sequence[int] = (32,), resolution=256,
                 in_channels=3, out_ch=3, dtype=torch.float32, device=None):
        super().__init__()
        # the decode half first: seeded random draws (init_random_ walks the
        # modules in this order) give the decoder the weights it had before
        # the encoder was ported
        self.decoder = Decoder(
            ch=ch, out_ch=out_ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
            attn_resolutions=attn_resolutions, resolution=resolution,
            z_channels=z_channels, zq_channels=embed_dim, dtype=dtype,
            device=device,
        )
        self.post_quant_conv = Linear(embed_dim, z_channels, dtype=dtype,
                                      device=device)
        self.encoder = Encoder(
            ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
            attn_resolutions=attn_resolutions, resolution=resolution,
            in_channels=in_channels, z_channels=z_channels, dtype=dtype,
            device=device,
        )
        self.quantize = VectorQuantizer(n_embed, embed_dim, device=device)
        self.quant_conv = Linear(z_channels, embed_dim, dtype=dtype, device=device)

    def encode(self, x):
        return self.quant_conv(self.encoder(x))

    def decode(self, quant):
        return self.decoder(self.post_quant_conv(quant), quant)


class AutoencoderKL(nn.Module):
    """The KL-VAE of Kandinsky 2.0 (autoencoder.py:110-157): ``encode``
    returns the posterior's (mean, log-variance clipped to [-30, 20]),
    ``decode`` maps latents to images through a plain-GroupNorm decoder."""

    def __init__(self, z_channels=4, embed_dim=4, ch=128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks=2,
                 attn_resolutions: Sequence[int] = (), resolution=256,
                 in_channels=3, out_ch=3, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        common = dict(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                      attn_resolutions=attn_resolutions, resolution=resolution, **kw)
        self.encoder = Encoder(in_channels=in_channels, z_channels=z_channels,
                               double_z=True, **common)
        self.decoder = Decoder(out_ch=out_ch, z_channels=z_channels, zq_channels=None,
                               **common)
        self.quant_conv = Linear(2 * z_channels, 2 * embed_dim, **kw)
        self.post_quant_conv = Linear(embed_dim, z_channels, **kw)

    def encode(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def sample_posterior(self, x, noise):
        """mean + exp(logvar / 2) · noise, ``noise`` of the latent's shape
        (taken in the latent's dtype)."""
        mean, logvar = self.encode(x)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x):
        return self.decode(self.encode(x)[0])


class VQModelInterface(nn.Module):
    """The plain VQ codec (autoencoder.py:89-107): the conv encoder, the
    codebook and a plain-GroupNorm decoder."""

    def __init__(self, z_channels=4, embed_dim=4, n_embed=16384, ch=128,
                 ch_mult: Sequence[int] = (1, 2, 2, 4), num_res_blocks=2,
                 attn_resolutions: Sequence[int] = (32,), resolution=256,
                 in_channels=3, out_ch=3, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        common = dict(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                      attn_resolutions=attn_resolutions, resolution=resolution, **kw)
        self.encoder = Encoder(in_channels=in_channels, z_channels=z_channels, **common)
        self.decoder = Decoder(out_ch=out_ch, z_channels=z_channels, zq_channels=None,
                               **common)
        self.quantize = VectorQuantizer(n_embed, embed_dim, device=device)
        self.quant_conv = Linear(z_channels, embed_dim, **kw)
        self.post_quant_conv = Linear(embed_dim, z_channels, **kw)

    def encode(self, x):
        return self.quant_conv(self.encoder(x))

    def decode(self, h, force_not_quantize: bool = False):
        if not force_not_quantize:
            h, _ = self.quantize(h)
        return self.decoder(self.post_quant_conv(h))

    def forward(self, x):
        return self.decode(self.encode(x))
