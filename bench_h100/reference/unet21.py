"""The Kandinsky 2.1 decoder UNet (ADM torso, ``Text2ImUNet21``), NHWC,
fp32: FiLM scale-shift resblocks with resblock up/down sampling, spatial
attention (64-wide heads) with the text and image tokens prepended to its
K/V, conditioned on XLM-R states, the pooled text and the CLIP image
embedding."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    Conv2d,
    GroupNorm32,
    LayerNormF32,
    Linear,
    attention,
    avg_pool_2x,
    timestep_embedding,
    upsample_nearest_2x,
)


class ResBlock(nn.Module):
    def __init__(self, channels, out_channels, emb_channels, up=False, down=False,
                 device=None):
        super().__init__()
        self.up, self.down = up, down
        self.in_layers = nn.ModuleList([GroupNorm32(channels, swish=1.0, device=device),
                                        nn.Identity(),
                                        Conv2d(channels, out_channels, device=device)])
        self.emb_layers = nn.ModuleList([nn.SiLU(),
                                         Linear(emb_channels, 2 * out_channels,
                                                device=device)])
        self.out_layers = nn.ModuleList([GroupNorm32(out_channels, swish=1.0, device=device),
                                         nn.Identity(), nn.Identity(),
                                         Conv2d(out_channels, out_channels, device=device)])
        self.skip_connection = (Linear(channels, out_channels, device=device)
                                if out_channels != channels else None)

    def forward(self, x, emb):
        h = self.in_layers[0](x)
        if self.up:
            x, h = upsample_nearest_2x(x), upsample_nearest_2x(h)
        elif self.down:
            x, h = avg_pool_2x(x), avg_pool_2x(h)
        h = self.in_layers[2](h)
        scale, shift = self.emb_layers[1](F.silu(emb))[:, None, None, :].chunk(2, dim=-1)
        h = self.out_layers[3](self.out_layers[0](h, film=(scale, shift)))
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h


class AttentionBlock(nn.Module):
    """Per-head [q|k|v] channels; the encoder K/V before the spatial K/V."""

    def __init__(self, channels, num_heads, encoder_channels, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels, device=device)
        self.qkv = Linear(channels, 3 * channels, device=device)
        self.encoder_kv = Linear(encoder_channels, 2 * channels, device=device)
        self.proj_out = Linear(channels, channels, device=device)

    def forward(self, x, encoder_out):
        B, H, W, C = x.shape
        heads, ch = self.num_heads, C // self.num_heads
        h = self.norm(x).reshape(B, H * W, C)
        q, k, v = self.qkv(h).reshape(B, H * W, heads, 3 * ch).split(ch, dim=-1)
        ek, ev = self.encoder_kv(encoder_out).reshape(
            B, encoder_out.shape[1], heads, 2 * ch).split(ch, dim=-1)
        a = attention(q, torch.cat([ek, k], dim=1), torch.cat([ev, v], dim=1))
        return x + self.proj_out(a.reshape(B, H * W, C)).reshape(B, H, W, C)


def build_plan(model_channels, num_res_blocks, channel_mult, attention_ds):
    """(input blocks, middle width, output blocks) as lists of
    (kind, in, out) layers, resblock up/down sampling."""
    ch = channel_mult[0] * model_channels
    inputs, chans, ds = [[("conv_in", 0, ch)]], [ch], 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            layers = [("res", ch, mult * model_channels)]
            ch = mult * model_channels
            if ds in attention_ds:
                layers.append(("attn", ch, ch))
            inputs.append(layers)
            chans.append(ch)
        if level != len(channel_mult) - 1:
            inputs.append([("res_down", ch, ch)])
            chans.append(ch)
            ds *= 2
    middle, outputs = ch, []
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks + 1):
            layers = [("res", ch + chans.pop(), model_channels * mult)]
            ch = model_channels * mult
            if ds in attention_ds:
                layers.append(("attn", ch, ch))
            if level and i == num_res_blocks:
                layers.append(("res_up", ch, ch))
                ds //= 2
            outputs.append(layers)
    return inputs, middle, outputs


class Text2ImUNet21(nn.Module):
    def __init__(self, in_channels, model_channels, out_channels, num_res_blocks,
                 attention_ds, channel_mult, num_head_channels, model_dim,
                 image_encoder_in_dim, text_encoder_in_dim1, text_encoder_in_dim2,
                 num_image_embs, device=None):
        super().__init__()
        self.model_channels = model_channels
        self.model_dim, self.num_image_embs = model_dim, num_image_embs
        emb_ch = 4 * model_channels
        inputs, middle, outputs = build_plan(model_channels, num_res_blocks, channel_mult,
                                             attention_ds)

        def make(spec):
            kind, cin, cout = spec
            if kind == "conv_in":
                return Conv2d(in_channels, cout, device=device)
            if kind == "attn":
                return AttentionBlock(cout, cout // num_head_channels, model_dim, device)
            return ResBlock(cin, cout, emb_ch, up=kind == "res_up", down=kind == "res_down",
                            device=device)

        self.input_blocks = nn.ModuleList(nn.ModuleList(make(s) for s in ls) for ls in inputs)
        self.middle_block = nn.ModuleList(make(s) for s in [
            ("res", middle, middle), ("attn", middle, middle), ("res", middle, middle)])
        self.output_blocks = nn.ModuleList(nn.ModuleList(make(s) for s in ls)
                                           for ls in outputs)
        last = outputs[-1][-1][2]
        self.out = nn.ModuleList([GroupNorm32(last, swish=1.0, device=device), nn.Identity(),
                                  Conv2d(last, out_channels, device=device)])
        self.time_embed = nn.ModuleList([Linear(model_channels, emb_ch, device=device),
                                         nn.SiLU(), Linear(emb_ch, emb_ch, device=device)])
        self.clip_to_seq = Linear(image_encoder_in_dim, model_dim * num_image_embs,
                                  device=device)
        self.to_model_dim_n = Linear(text_encoder_in_dim1, model_dim, device=device)
        self.proj_n = Linear(text_encoder_in_dim2, emb_ch, device=device)
        self.ln_model_n = LayerNormF32(emb_ch, device=device)
        self.img_layer = Linear(image_encoder_in_dim, emb_ch, device=device)

    def forward(self, x, timesteps, full_emb, pooled_emb, image_emb):
        B = image_emb.shape[0]
        clip_seq = self.clip_to_seq(image_emb).reshape(B, self.num_image_embs, self.model_dim)
        xf_proj = self.ln_model_n(self.proj_n(pooled_emb)) + self.img_layer(image_emb)
        xf_out = torch.cat([clip_seq, self.to_model_dim_n(full_emb)], dim=1)
        te = self.time_embed
        emb = te[2](F.silu(te[0](timestep_embedding(timesteps, self.model_channels))))
        emb = emb + xf_proj

        def run(layers, h):
            for layer in layers:
                if isinstance(layer, ResBlock):
                    h = layer(h, emb)
                elif isinstance(layer, AttentionBlock):
                    h = layer(h, xf_out)
                else:
                    h = layer(h)
            return h

        h, hs = x, []
        for layers in self.input_blocks:
            h = run(layers, h)
            hs.append(h)
        h = run(self.middle_block, h)
        for layers in self.output_blocks:
            h = run(layers, torch.cat([h, hs.pop()], dim=-1))
        return self.out[2](self.out[0](h))


def unet21_kwargs(mc: dict) -> dict:
    """Text2ImUNet21's arguments from a 2.1 ``model_config``."""
    size = mc["image_size"]
    mult = ({256: (1, 1, 2, 2, 4, 4), 128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4)}[size]
            if mc["channel_mult"] == "" else
            tuple(int(m) for m in mc["channel_mult"].split(",")))
    return dict(
        in_channels=mc["in_channels"], model_channels=mc["num_channels"],
        out_channels=mc["out_channels"], num_res_blocks=mc["num_res_blocks"],
        attention_ds=tuple(size // int(r) for r in mc["attention_resolutions"].split(",")),
        channel_mult=mult, num_head_channels=mc["num_head_channels"],
        model_dim=mc["model_dim"], image_encoder_in_dim=mc["image_encoder_in_dim"],
        text_encoder_in_dim1=mc["text_encoder_in_dim1"],
        text_encoder_in_dim2=mc["text_encoder_in_dim2"],
        num_image_embs=mc["num_image_embs"])
