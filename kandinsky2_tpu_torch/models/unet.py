"""ADM-style latent UNet, NHWC, the counterpart of
``kandinsky2_tpu/models/unet.py``: ``ResBlock``, ``AttentionBlock``,
``Downsample``, ``Upsample``, the ``UNetModel`` torso, the 2.1 text+image
conditioned ``Text2ImUNet21`` with its ``encode_conditioning`` / ``denoise``
split, its inpainting variant ``InpaintText2ImUNet21``, the super-resolution
UNets (``SuperResUNetModel``, ``SuperResInpaintUNetModel``,
``SuperResText2ImUNet21``), and the turbo
deep cache (``deep_cache_spec``, ``run_torso_cached``, ``denoise_cached``);
the 2.0 dual-text ``Text2ImUNet20`` (XLM-R and mT5 tokens as cross-attention
K/V, an ``AttentionPooling`` of the mT5 sequence in the time embedding) and
its ``InpaintText2ImUNet20``, on the same torso.

Every GroupNorm runs the GroupNorm kernel pair on a CUDA tensor, and the
spatial attention (encoder K/V prepended to the spatial K/V, so S = T +
tokens) the flash-attention kernel where ``ops.attention.use_flash_kernel``
sends it (bf16, d = 64).

Spatial parallelism (``parallel/spatial.py``): with ``sp_axis`` set (a
``parallel.mesh.MeshAxis``, by ``parallel.spatial.using_sp_axis`` or the
constructors) the torso takes this rank's rows of a row-sharded latent:
halo rows before every 3x3 convolution (a top halo before the stride-2
``Downsample``), statistics over the whole image in every GroupNorm, and
attention of the local queries against gathered K/V, or the ring above
``RING_THRESHOLD_TOKENS`` tokens (``unet.py:120-174`` of the JAX package).
The parameters are the same either way, and the sharded forward is
differentiable end to end (row-sharded training, ``train_unclip``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import qkv_attention
from ..parallel import spatial as _sp
from ..parallel.collectives import all_gather
from .layers import (
    AttentionPooling,
    Conv2d,
    GroupNorm32,
    LayerNormF32,
    Linear,
    avg_pool_2x,
    resize_bilinear,
    timestep_embedding,
    upsample_nearest_2x,
)


class ResBlock(nn.Module):
    """Residual block with FiLM scale-shift GroupNorm (unet.py:110-220).
    The nearest upsample and the 2x2 average pool keep even row shards
    aligned, so only the convolutions and norms see the shards."""

    def __init__(self, channels, out_channels, emb_channels,
                 use_scale_shift_norm=True, up=False, down=False,
                 dtype=torch.float32, device=None, sp_axis=None):
        super().__init__()
        self.up, self.down = up, down
        self.sp_axis = sp_axis
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.ModuleList([
            GroupNorm32(channels, swish=1.0, device=device, sp_axis=sp_axis),
            nn.Identity(),
            Conv2d(channels, out_channels, dtype=dtype, device=device),
        ])
        emb_dim = 2 * out_channels if use_scale_shift_norm else out_channels
        self.emb_layers = nn.ModuleList([
            nn.SiLU(), Linear(emb_channels, emb_dim, dtype=dtype, device=device),
        ])
        self.out_layers = nn.ModuleList([
            GroupNorm32(out_channels, swish=1.0, device=device, sp_axis=sp_axis),
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
        h = _sp.sp_conv3x3(self.in_layers[2], h, self.sp_axis)
        emb_out = self.emb_layers[1](F.silu(emb)).to(h.dtype)[:, None, None, :]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = self.out_layers[0](h, film=(scale, shift))
        else:
            h = self.out_layers[0](h + emb_out)
        h = _sp.sp_conv3x3(self.out_layers[3], h, self.sp_axis)
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h


class AttentionBlock(nn.Module):
    """Spatial self-attention with the encoder K/V, where the block has an
    ``encoder_kv`` projection (``encoder_channels`` not None), concatenated
    before the spatial K/V (unet.py:223-340); per-head [q|k|v] channel
    layout.  On row shards the local queries attend to the all-gathered
    spatial K/V, or, above ``RING_THRESHOLD_TOKENS`` tokens, to the ring
    (``parallel.spatial.sp_ring_attention_mh``) with the encoder K/V as a
    replicated prefix."""

    def __init__(self, channels, num_heads, encoder_channels=None,
                 dtype=torch.float32, device=None, sp_axis=None):
        super().__init__()
        self.num_heads = num_heads
        self.sp_axis = sp_axis
        self.norm = GroupNorm32(channels, device=device, sp_axis=sp_axis)
        self.qkv = Linear(channels, 3 * channels, dtype=dtype, device=device)
        self.encoder_kv = (None if encoder_channels is None else
                           Linear(encoder_channels, 2 * channels, dtype=dtype,
                                  device=device))
        self.proj_out = Linear(channels, channels, dtype=dtype, device=device)

    def forward(self, x, encoder_out=None):
        B, H, W, C = x.shape
        heads = self.num_heads
        ch = C // heads
        h = self.norm(x).reshape(B, H * W, C)
        q, k, v = self.qkv(h).reshape(B, H * W, heads, 3 * ch).split(ch, dim=-1)
        ek = ev = None
        if self.encoder_kv is not None:
            ekv = self.encoder_kv(encoder_out).reshape(
                B, encoder_out.shape[1], heads, 2 * ch
            )
            ek, ev = ekv.split(ch, dim=-1)
        sp = self.sp_axis
        if sp is not None and H * W * sp.size > _sp.RING_THRESHOLD_TOKENS:
            a = _sp.sp_ring_attention_mh(q, k, v, sp, extra_k=ek, extra_v=ev)
        else:
            if sp is not None:
                k, v = all_gather(k, sp, dim=1), all_gather(v, sp, dim=1)
            if ek is not None:
                k = torch.cat([ek, k], dim=1)
                v = torch.cat([ev, v], dim=1)
            a = qkv_attention(q, k, v)
        a = a.reshape(B, H * W, C)
        return x + self.proj_out(a).reshape(B, H, W, C)


class Downsample(nn.Module):
    """Strided-conv downsample (unet.py:80-107); on row shards a top halo
    row only (``parallel.spatial.sp_conv3x3_down``)."""

    def __init__(self, channels, out_channels, dtype=torch.float32, device=None,
                 sp_axis=None):
        super().__init__()
        self.sp_axis = sp_axis
        self.op = Conv2d(channels, out_channels, stride=2, dtype=dtype,
                         device=device)

    def forward(self, x):
        if self.sp_axis is None:
            return self.op(x)
        return _sp.sp_conv3x3_down(self.op, x, self.sp_axis)


class Upsample(nn.Module):
    """Nearest 2x + 3x3 conv (unet.py:48-77), the halo conv on row shards."""

    def __init__(self, channels, out_channels, dtype=torch.float32, device=None,
                 sp_axis=None):
        super().__init__()
        self.sp_axis = sp_axis
        self.conv = Conv2d(channels, out_channels, dtype=dtype, device=device)

    def forward(self, x):
        return _sp.sp_conv3x3(self.conv, upsample_nearest_2x(x), self.sp_axis)


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


def deep_cache_spec(unet, split: Optional[int] = None):
    """(spatial divisor, channels) of the deep-branch cache that
    ``run_torso_cached`` keeps for ``unet`` at ``split`` (unet.py:261-283):
    the first ``split`` input blocks stay hot, by default all of level 0
    (num_res_blocks + 1)."""
    split = unet.num_res_blocks + 1 if split is None else split
    input_plan, middle_ch, output_plan = _build_plan(
        unet.model_channels, unet.num_res_blocks, unet.channel_mult,
        unet.attention_resolutions, unet.resblock_updown,
    )
    L = len(input_plan)
    if not 1 <= split < L:
        raise ValueError(f"split must be in [1, {L}), got {split}")
    ds = 1
    for layers in input_plan[:split]:
        for kind, _, _ in layers:
            if kind in ("down", "res_down"):
                ds *= 2
    # the feature entering output block L - split: the out channels of the
    # last deep output layer (or the middle block's)
    ch = output_plan[L - split - 1][-1][2] if L - split - 1 >= 0 else middle_ch
    return ds, ch


class UNetModel(nn.Module):
    """UNet torso + timestep embedding (unet.py:343-611)."""

    def __init__(self, in_channels=4, model_channels=384, out_channels=8,
                 num_res_blocks=3, attention_resolutions=(2, 4, 8),
                 channel_mult=(1, 2, 3, 4), num_heads=1, num_head_channels=64,
                 num_heads_upsample=-1, use_scale_shift_norm=True,
                 resblock_updown=True, encoder_channels=None,
                 dtype=torch.float32, device=None, sp_axis=None):
        super().__init__()
        self.dtype = dtype
        self.sp_axis = sp_axis
        self.model_channels = model_channels
        self.num_head_channels = num_head_channels
        self.num_heads = num_heads
        self.num_heads_upsample = num_heads_upsample
        self.num_res_blocks = num_res_blocks
        self.channel_mult = tuple(channel_mult)
        self.attention_resolutions = tuple(attention_resolutions)
        self.resblock_updown = resblock_updown
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
                                dtype=dtype, device=device, sp_axis=sp_axis)
            if kind == "attn":
                return AttentionBlock(cout, self._heads(cout, upsample_branch),
                                      encoder_channels, dtype=dtype,
                                      device=device, sp_axis=sp_axis)
            if kind == "down":
                return Downsample(cin, cout, dtype=dtype, device=device,
                                  sp_axis=sp_axis)
            if kind == "up":
                return Upsample(cin, cout, dtype=dtype, device=device,
                                sp_axis=sp_axis)
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
            GroupNorm32(output_plan[-1][-1][2], swish=1.0, device=device,
                        sp_axis=sp_axis),
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

    def _run_layer(self, layer, h, emb, encoder_out):
        if isinstance(layer, ResBlock):
            return layer(h, emb)
        if isinstance(layer, AttentionBlock):
            return layer(h, encoder_out)
        if isinstance(layer, Conv2d):  # the input conv: halo rows on shards
            return _sp.sp_conv3x3(layer, h, self.sp_axis)
        return layer(h)

    def run_torso(self, x, emb, encoder_out=None):
        return self.run_torso_cached(x, emb, None, True, encoder_out)[0]

    def run_torso_cached(self, x, emb, cache, refresh: bool, encoder_out=None,
                         split: Optional[int] = None):
        """The torso, with DeepCache (unet.py:440): the deep branch (the
        input blocks from ``split`` on, by default those after level 0, the
        middle block and the matching deep output blocks) runs only where
        ``refresh``; otherwise the cached deep feature is used.  Returns
        ``(out, new_cache)``; ``cache`` has the shape of
        ``deep_cache_spec(unet, split)``, and the first step must refresh.
        ``run_torso`` is the call that always refreshes."""
        split = self.num_res_blocks + 1 if split is None else split
        L = len(self.input_blocks)
        h = x.to(self.dtype)
        hs = []
        for layers in self.input_blocks[:split]:
            for layer in layers:
                h = self._run_layer(layer, h, emb, encoder_out)
            hs.append(h)
        if refresh:
            deep_hs = []
            for layers in self.input_blocks[split:]:
                for layer in layers:
                    h = self._run_layer(layer, h, emb, encoder_out)
                deep_hs.append(h)
            for layer in self.middle_block:
                h = self._run_layer(layer, h, emb, encoder_out)
            for layers in self.output_blocks[:L - split]:
                h = torch.cat([h, deep_hs.pop()], dim=-1)
                for layer in layers:
                    h = self._run_layer(layer, h, emb, encoder_out)
            h = h.to(self.dtype)
        else:
            h = cache.to(self.dtype)
        new_cache = h
        for layers in self.output_blocks[L - split:]:
            h = torch.cat([h, hs.pop()], dim=-1)
            for layer in layers:
                h = self._run_layer(layer, h, emb, encoder_out)
        out = _sp.sp_conv3x3(self.out[2], self.out[0](h.float()), self.sp_axis)
        return out, new_cache

    def time_embedding(self, timesteps):
        temb = timestep_embedding(timesteps, self.model_channels)
        return self.time_embed[2](F.silu(self.time_embed[0](temb)))

    def forward(self, x, timesteps, encoder_out=None):
        return self.run_torso(x, self.time_embedding(timesteps), encoder_out)


class Text2ImUNet21(UNetModel):
    """Kandinsky 2.1 conditioned UNet (text2im_model2_1.py:13-129): the CLIP
    image embedding becomes ``num_image_embs`` tokens prepended to the
    projected XLM-R tokens as cross-attention K/V; the pooled text embedding
    (or, with ``pooling_type`` other than "from_model", an
    ``AttentionPooling`` of the XLM-R tokens) and the image embedding add
    to the timestep embedding."""

    def __init__(self, model_dim=768, image_encoder_in_dim=768,
                 text_encoder_in_dim1=1024, text_encoder_in_dim2=768,
                 num_image_embs=10, pooling_type="from_model", dtype=torch.float32,
                 device=None, **kw):
        super().__init__(encoder_channels=model_dim, dtype=dtype, device=device,
                         **kw)
        mc4 = self.model_channels * 4
        self.model_dim = model_dim
        self.num_image_embs = num_image_embs
        self.pooling_type = pooling_type
        self.clip_to_seq = Linear(image_encoder_in_dim, model_dim * num_image_embs,
                                  dtype=dtype, device=device)
        self.to_model_dim_n = Linear(text_encoder_in_dim1, model_dim, dtype=dtype,
                                     device=device)
        if pooling_type == "from_model":
            self.proj_n = Linear(text_encoder_in_dim2, mc4, dtype=dtype, device=device)
        else:
            self.proj_n = AttentionPooling(8, text_encoder_in_dim1, mc4, dtype=dtype,
                                           device=device)
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
        xf_proj = self.ln_model_n(self.proj_n(
            pooled_emb if self.pooling_type == "from_model" else full_emb))
        xf_proj = xf_proj + self.img_layer(image_emb)
        xf_out = torch.cat([clip_seq, self.to_model_dim_n(full_emb)], dim=1)
        return xf_proj, xf_out

    def denoise(self, x, timesteps, xf_proj, xf_out):
        emb = self.time_embedding(timesteps) + xf_proj.float()
        return self.run_torso(x, emb, xf_out)

    def denoise_cached(self, x, timesteps, xf_proj, xf_out, cache, refresh: bool):
        """``denoise`` with the deep branch cached across steps
        (``run_torso_cached``).  Returns (out, new_cache)."""
        emb = self.time_embedding(timesteps) + xf_proj.float()
        return self.run_torso_cached(x, emb, cache, refresh, xf_out)

    def forward(self, x, timesteps, full_emb, pooled_emb, image_emb):
        xf_proj, xf_out = self.encode_conditioning(full_emb, pooled_emb, image_emb)
        return self.denoise(x, timesteps, xf_proj, xf_out)


def inpaint_input(x, inpaint_image, inpaint_mask):
    """The inpainting UNets' input x ⊕ image·mask ⊕ mask (zeros where not
    given)."""
    if inpaint_image is None:
        inpaint_image = torch.zeros_like(x)
    if inpaint_mask is None:
        inpaint_mask = torch.zeros_like(x[..., :1])
    return torch.cat([x, inpaint_image * inpaint_mask, inpaint_mask], dim=-1)


class InpaintText2ImUNet21(Text2ImUNet21):
    """2.1 inpainting UNet (text2im_model2_1.py:131-155): the input is
    x ⊕ image·mask ⊕ mask, so ``in_channels`` is 2C + 1 (the factory sets
    it)."""

    def denoise(self, x, timesteps, xf_proj, xf_out, inpaint_image=None,
                inpaint_mask=None):
        return super().denoise(inpaint_input(x, inpaint_image, inpaint_mask),
                               timesteps, xf_proj, xf_out)

    def denoise_cached(self, x, timesteps, xf_proj, xf_out, inpaint_image,
                       inpaint_mask, cache, refresh: bool):
        return super().denoise_cached(
            inpaint_input(x, inpaint_image, inpaint_mask), timesteps, xf_proj,
            xf_out, cache, refresh)

    def forward(self, x, timesteps, full_emb, pooled_emb, image_emb,
                inpaint_image=None, inpaint_mask=None):
        xf_proj, xf_out = self.encode_conditioning(full_emb, pooled_emb, image_emb)
        return self.denoise(x, timesteps, xf_proj, xf_out, inpaint_image,
                            inpaint_mask)


class SuperResUNetModel(UNetModel):
    """Super-resolution UNet (unet.py:614-635): the input is x ⊕ the
    bilinear upsampled low-resolution image, so ``in_channels`` is 2C."""

    def forward(self, x, timesteps, low_res=None, encoder_out=None):
        up = resize_bilinear(low_res, x.shape[1:3]).to(x.dtype)
        return super().forward(torch.cat([x, up], dim=-1), timesteps, encoder_out)


class SuperResInpaintUNetModel(UNetModel):
    """Joint super-resolution and inpainting UNet (unet.py:665-701): the
    input is x ⊕ image·mask ⊕ mask ⊕ the upsampled low-resolution image,
    3C + 1 channels."""

    def forward(self, x, timesteps, inpaint_image=None, inpaint_mask=None,
                low_res=None, encoder_out=None):
        up = resize_bilinear(low_res, x.shape[1:3]).to(x.dtype)
        x = torch.cat([inpaint_input(x, inpaint_image, inpaint_mask), up], dim=-1)
        return super().forward(x, timesteps, encoder_out)


class SuperResText2ImUNet21(Text2ImUNet21):
    """The 2.1 text-conditioned super-resolution UNet
    (text2im_model2_1.py:106-129): ``Text2ImUNet21`` on x ⊕ the upsampled
    low-resolution image."""

    def denoise(self, x, timesteps, xf_proj, xf_out, low_res=None):
        up = resize_bilinear(low_res, x.shape[1:3]).to(x.dtype)
        return super().denoise(torch.cat([x, up], dim=-1), timesteps, xf_proj, xf_out)

    def forward(self, x, timesteps, full_emb, pooled_emb, image_emb, low_res=None):
        xf_proj, xf_out = self.encode_conditioning(full_emb, pooled_emb, image_emb)
        return self.denoise(x, timesteps, xf_proj, xf_out, low_res)


T5_DIM = 512  # the mT5-small width that Text2ImUNet20's projections take


class Text2ImUNet20(UNetModel):
    """Kandinsky 2.0 conditioned UNet (text2im_model.py:13-111): the
    projected XLM-R tokens and the projected mT5 tokens, concatenated, are
    the cross-attention K/V (77 + 77 at full width); the pooled XLM-R
    embedding (or, with ``pooling_type`` other than "from_model", an
    ``AttentionPooling`` of its tokens) and an ``AttentionPooling`` of the
    mT5 tokens add to the timestep embedding.  The mT5 width is fixed at
    ``T5_DIM``, as in the reference."""

    def __init__(self, model_dim=768, text_encoder_in_dim1=1024,
                 text_encoder_in_dim2=640, pooling_type="from_model",
                 dtype=torch.float32, device=None, **kw):
        super().__init__(encoder_channels=model_dim, dtype=dtype, device=device,
                         **kw)
        mc4 = self.model_channels * 4
        lin = dict(dtype=dtype, device=device)
        self.pooling_type = pooling_type
        self.to_model_dim = Linear(text_encoder_in_dim1, model_dim, **lin)
        if pooling_type == "from_model":
            self.proj = Linear(text_encoder_in_dim2, mc4, **lin)
        else:
            self.proj = AttentionPooling(8, text_encoder_in_dim2, mc4,
                                         x_dim=text_encoder_in_dim1, **lin)
        self.proj2 = AttentionPooling(8, T5_DIM, mc4, **lin)
        self.to_model_dim2 = Linear(T5_DIM, model_dim, **lin)
        self.ln_model1 = LayerNormF32(model_dim, device=device)
        self.ln_model2 = LayerNormF32(mc4, device=device)
        self.ln_model3 = LayerNormF32(mc4, device=device)

    def encode_conditioning(self, full_emb1, pooled_emb1, full_emb2, pooled_emb2=None):
        """(xf_proj, xf_out): the time-embedding
        addend ln2(proj(pooled1)) + ln3(proj2(full2)) and the tokens
        ln1([to_model_dim(full1); to_model_dim2(full2)]), once per call;
        ``pooled_emb2`` is unused, as in the reference."""
        xf_proj = self.ln_model2(self.proj(
            pooled_emb1 if self.pooling_type == "from_model" else full_emb1))
        xf_proj = xf_proj + self.ln_model3(self.proj2(full_emb2))
        xf_out = self.ln_model1(torch.cat(
            [self.to_model_dim(full_emb1), self.to_model_dim2(full_emb2)], dim=1))
        return xf_proj, xf_out

    def denoise(self, x, timesteps, xf_proj, xf_out):
        emb = self.time_embedding(timesteps) + xf_proj.float()
        return self.run_torso(x, emb, xf_out)

    def forward(self, x, timesteps, full_emb1, pooled_emb1, full_emb2,
                pooled_emb2=None):
        xf_proj, xf_out = self.encode_conditioning(full_emb1, pooled_emb1, full_emb2,
                                                   pooled_emb2)
        return self.denoise(x, timesteps, xf_proj, xf_out)


class InpaintText2ImUNet20(Text2ImUNet20):
    """2.0 inpainting UNet (text2im_model.py:114-137): the input is
    x ⊕ image·mask ⊕ mask, 2C + 1 channels."""

    def denoise(self, x, timesteps, xf_proj, xf_out, inpaint_image=None,
                inpaint_mask=None):
        return super().denoise(inpaint_input(x, inpaint_image, inpaint_mask),
                               timesteps, xf_proj, xf_out)

    def forward(self, x, timesteps, full_emb1, pooled_emb1, full_emb2,
                pooled_emb2=None, inpaint_image=None, inpaint_mask=None):
        xf_proj, xf_out = self.encode_conditioning(full_emb1, pooled_emb1, full_emb2,
                                                   pooled_emb2)
        return self.denoise(x, timesteps, xf_proj, xf_out, inpaint_image,
                            inpaint_mask)
