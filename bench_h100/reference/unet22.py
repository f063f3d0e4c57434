"""The Kandinsky 2.2 decoder UNet (diffusers UNet2DConditionModel of
kandinsky-2-2-decoder), NHWC, fp32: resnets with scale-shift time
conditioning and resnet up/down sampling, added-KV attention after the
resnets of levels 1-3 and in the middle."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    Container,
    Conv2d,
    GroupNorm32,
    LayerNormF32,
    Linear,
    attention,
    avg_pool_2x,
    timestep_embedding,
    upsample_nearest_2x,
)


class ResnetBlock22(nn.Module):
    def __init__(self, cin, cout, temb, up=False, down=False, eps=1e-5, device=None):
        super().__init__()
        self.up, self.down = up, down
        self.norm1 = GroupNorm32(cin, eps=eps, swish=1.0, device=device)
        self.conv1 = Conv2d(cin, cout, device=device)
        self.time_emb_proj = Linear(temb, 2 * cout, device=device)
        self.norm2 = GroupNorm32(cout, eps=eps, swish=1.0, device=device)
        self.conv2 = Conv2d(cout, cout, device=device)
        self.conv_shortcut = Linear(cin, cout, device=device) if cin != cout else None

    def forward(self, x, temb):
        h = self.norm1(x)
        if self.up:
            x, h = upsample_nearest_2x(x), upsample_nearest_2x(h)
        elif self.down:
            x, h = avg_pool_2x(x), avg_pool_2x(h)
        h = self.conv1(h)
        emb = self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h, film=emb.chunk(2, dim=-1)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AddedKVAttention(nn.Module):
    """GroupNorm'd spatial tokens; the image tokens' add_k/add_v prepended
    to the spatial K/V."""

    def __init__(self, channels, heads, cross_dim, eps=1e-5, device=None):
        super().__init__()
        self.heads = heads
        self.group_norm = GroupNorm32(channels, eps=eps, device=device)
        self.to_q = Linear(channels, channels, device=device)
        self.to_k = Linear(channels, channels, device=device)
        self.to_v = Linear(channels, channels, device=device)
        self.add_k_proj = Linear(cross_dim, channels, device=device)
        self.add_v_proj = Linear(cross_dim, channels, device=device)
        self.to_out = nn.ModuleList([Linear(channels, channels, device=device)])

    def forward(self, x, enc):
        B, H, W, C = x.shape
        heads = (B, -1, self.heads, C // self.heads)
        h = self.group_norm(x).reshape(B, H * W, C)
        q = self.to_q(h).reshape(heads)
        k = torch.cat([self.add_k_proj(enc).reshape(heads), self.to_k(h).reshape(heads)], 1)
        v = torch.cat([self.add_v_proj(enc).reshape(heads), self.to_v(h).reshape(heads)], 1)
        a = attention(q, k, v).reshape(B, H * W, C)
        return x + self.to_out[0](a).reshape(B, H, W, C)


class _Level(nn.Module):
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
        attns = list(getattr(self, "attentions", []))
        return [(r, attns[j] if j < len(attns) else None) for j, r in enumerate(self.resnets)]


class UNet22(nn.Module):
    def __init__(self, in_channels, out_channels, block_out_channels, layers_per_block,
                 attention_head_dim, cross_attention_dim, encoder_hid_dim, num_image_tokens,
                 down_block_types, up_block_types, eps=1e-5, device=None):
        super().__init__()
        ch0 = block_out_channels[0]
        tdim = 4 * ch0
        self.ch0 = ch0
        self.tokens = (num_image_tokens, cross_attention_dim)
        self.time_embedding = Container(linear_1=Linear(ch0, tdim, device=device),
                                        linear_2=Linear(tdim, tdim, device=device))
        self.encoder_hid_proj = Container(
            image_embeds=Linear(encoder_hid_dim, num_image_tokens * cross_attention_dim,
                                device=device),
            norm=LayerNormF32(cross_attention_dim, device=device))
        self.add_embedding = Container(
            image_proj=Linear(encoder_hid_dim, tdim, device=device),
            image_norm=LayerNormF32(tdim, device=device))
        self.conv_in = Conv2d(in_channels, ch0, device=device)
        res = lambda cin, cout, **kw: ResnetBlock22(cin, cout, tdim, eps=eps, device=device,
                                                    **kw)
        attn = lambda c: AddedKVAttention(c, c // attention_head_dim, cross_attention_dim,
                                          eps, device)
        n = len(block_out_channels)
        skips, ch, down = [ch0], ch0, []
        for i, out_ch in enumerate(block_out_channels):
            resnets, attns = [], []
            for _ in range(layers_per_block):
                resnets.append(res(ch, out_ch))
                ch = out_ch
                skips.append(ch)
                if "CrossAttn" in down_block_types[i]:
                    attns.append(attn(ch))
            sampler = None
            if i != n - 1:
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
            up.append(_Level(resnets, attns, "upsamplers",
                             res(ch, ch, up=True) if i != n - 1 else None))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm32(ch, eps=eps, swish=1.0, device=device)
        self.conv_out = Conv2d(ch, out_channels, device=device)

    def forward(self, x, timesteps, image_embeds):
        """x [B, h, w, C], timesteps [B], image_embeds [B, encoder_hid_dim]."""
        B = x.shape[0]
        ehp, ae = self.encoder_hid_proj, self.add_embedding
        enc = ehp.norm(ehp.image_embeds(image_embeds).reshape(B, *self.tokens))
        te = self.time_embedding
        emb = (te.linear_2(F.silu(te.linear_1(
            timestep_embedding(timesteps, self.ch0, sin_first=True))))
            + ae.image_norm(ae.image_proj(image_embeds)))
        h = self.conv_in(x)
        hs = [h]

        def run(level, h, save=None, skips=None):
            for res, attn in level.layers():
                if skips is not None:
                    h = torch.cat([h, skips.pop()], dim=-1)
                h = res(h, emb)
                if attn is not None:
                    h = attn(h, enc)
                if save is not None:
                    save.append(h)
            return h

        for level in self.down_blocks:
            h = run(level, h, save=hs)
            if level.sampler is not None:
                h = level.sampler(h, emb)
                hs.append(h)
        h = run(self.mid_block, h)
        for level in self.up_blocks:
            h = run(level, h, skips=hs)
            if level.sampler is not None:
                h = level.sampler(h, emb)
        return self.conv_out(self.conv_norm_out(h))
