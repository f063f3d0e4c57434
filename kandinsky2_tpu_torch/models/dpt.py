"""DPT monocular depth (Ranftl et al., "Vision Transformers for Dense
Prediction") in PyTorch, the counterpart of ``kandinsky2_tpu/models/dpt.py``:
the pure-ViT family (Intel/dpt-large) and the MiDaS hybrid (Intel/dpt-hybrid-
midas, the depth model of the reference notebook's ``MidasDetector``), HF
``DPTForDepthEstimation`` graphs with its state_dict names.

* Pure ViT: patch conv /16, cls token, position embeddings (bilinearly
  resized for another grid), pre-LN layers with exact GELU; four taps at
  ``backbone_out_indices`` through readout (cls concat, Linear, GELU), a 1x1
  projection and a resize by ``reassemble_factors`` (4 and 2: a
  stride-equals-kernel transposed conv, one matmul per pixel; 0.5: a
  strided 3x3 conv).
* Hybrid: a BiT stem (weight-standardised convs, in fp32 with eps 1e-8 and
  TF-SAME padding; GroupNorm + ReLU; bottleneck stages) gives the patch
  grid through a 1x1 projection, and its first two stages' maps go straight
  to the neck's 3x3 convs.
* Then 3x3 convs to ``fusion_hidden_size``, the RefineNet fusion ladder
  (pre-activation residual units, x2 align-corners bilinear upsampling) and
  the depth head.

The ViT attention has the semantics of ``ops.attention.added_kv_attention``
(fp32 logits of the activations, one 1/√d scale, fp32 softmax, P cast to
v's dtype), so bf16 at d = 64 runs the flash kernel K3; BiT's GroupNorms run
the GroupNorm kernels.  Parameters stay fp32 and every layer computes in
``dtype``, as in the JAX module.  Images are NHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import added_kv_attention
from .layers import Container, Conv2d, GroupNorm32, LayerNormF32, Linear


def resize_bilinear_align_corners(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """NHWC bilinear resize with align_corners=True (the DPT fusion and
    head upsamplers)."""
    if tuple(x.shape[1:3]) == (oh, ow):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


def _resize_half_pixel(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """NHWC bilinear resize, half-pixel centres (``jax.image.resize``
    "bilinear", antialiased where it shrinks)."""
    shrink = oh < x.shape[1] or ow < x.shape[2]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return y.permute(0, 2, 3, 1)


class _ViTLayer(nn.Module):
    """Pre-LN ViT encoder layer (``dpt.encoder.layer.N``)."""

    def __init__(self, hidden, heads, intermediate, eps, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.layernorm_before = LayerNormF32(hidden, eps, device=device)
        self.attention = Container(
            attention=Container(query=Linear(hidden, hidden, **kw),
                                key=Linear(hidden, hidden, **kw),
                                value=Linear(hidden, hidden, **kw)),
            output=Container(dense=Linear(hidden, hidden, **kw)))
        self.layernorm_after = LayerNormF32(hidden, eps, device=device)
        self.intermediate = Container(dense=Linear(hidden, intermediate, **kw))
        self.output = Container(dense=Linear(intermediate, hidden, **kw))

    def forward(self, x):
        h = self.layernorm_before(x)
        att = self.attention.attention
        B, T, W = x.shape
        q, k, v = (lin(h).reshape(B, T, self.heads, W // self.heads)
                   for lin in (att.query, att.key, att.value))
        x = x + self.attention.output.dense(added_kv_attention(q, k, v).reshape(B, T, W))
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(h)


class _TransposeUpsample(nn.Module):
    """A ConvTranspose2d whose stride equals its kernel, as one matmul per
    pixel; the weight keeps torch's [in, out, k, k] layout."""

    def __init__(self, channels, factor, dtype, device):
        super().__init__()
        self.factor, self.dtype = factor, dtype
        self.weight = nn.Parameter(torch.zeros(channels, channels, factor, factor,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        B, H, W, _ = x.shape
        s, dt = self.factor, self.dtype
        y = torch.einsum("bhwc,copq->bhpwqo", x.to(dt), self.weight.to(dt))
        return y.reshape(B, H * s, W * s, -1) + self.bias.to(dt)


class _PreActResidual(nn.Module):
    """DPTPreActResidualLayer: relu, conv, relu, conv, plus the input."""

    def __init__(self, channels, dtype, device):
        super().__init__()
        self.convolution1 = Conv2d(channels, channels, dtype=dtype, device=device)
        self.convolution2 = Conv2d(channels, channels, dtype=dtype, device=device)

    def forward(self, x):
        return x + self.convolution2(F.relu(self.convolution1(F.relu(x))))


def _same_pad(size: int, kernel: int, stride: int) -> tuple:
    """(before, after) TF-SAME padding of one spatial axis."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _WSConv(nn.Module):
    """BiT's weight-standardised conv: the kernel standardised per output
    channel in fp32 (eps 1e-8) at every call, no bias, TF-SAME padding."""

    def __init__(self, cin, cout, kernel=3, stride=1, eps=1e-8, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.stride, self.eps, self.dtype = stride, eps, dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel, device=device))

    def forward(self, x):
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = ((w - mean) * torch.rsqrt(var + self.eps)).to(self.dtype)
        k, s = w.shape[-1], self.stride
        ph, pw = _same_pad(x.shape[1], k, s), _same_pad(x.shape[2], k, s)
        x = F.pad(x.to(self.dtype).permute(0, 3, 1, 2), (*pw, *ph))
        return F.conv2d(x, w, stride=s).permute(0, 2, 3, 1)


def _make_div(value: float, divisor: int = 8) -> int:
    """timm's channel rounding (modeling_bit.py make_div)."""
    new_value = max(divisor, int(value + divisor / 2) // divisor * divisor)
    if new_value < 0.9 * value:
        new_value += divisor
    return new_value


class _BitBottleneck(nn.Module):
    """BiT's non-pre-activation bottleneck: three WS convs, each followed by
    a GroupNorm (and ReLU on the first two), a projection shortcut on a
    stage's first layer, ReLU after the sum."""

    def __init__(self, cin, cout, stride, num_groups, is_first, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        mid = _make_div(cout * 0.25)
        gn = lambda c: GroupNorm32(c, num_groups, 1e-5, device=device)
        self.downsample = (Container(conv=_WSConv(cin, cout, 1, stride, **kw), norm=gn(cout))
                           if is_first else None)
        self.conv1, self.norm1 = _WSConv(cin, mid, 1, **kw), gn(mid)
        self.conv2, self.norm2 = _WSConv(mid, mid, 3, stride, **kw), gn(mid)
        self.conv3, self.norm3 = _WSConv(mid, cout, 1, **kw), gn(cout)

    def forward(self, x):
        shortcut = x
        if self.downsample is not None:
            shortcut = self.downsample.norm(self.downsample.conv(x))
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        return F.relu(self.norm3(self.conv3(h)) + shortcut)


class _BitBackbone(nn.Module):
    """BiT stem (WS 7x7/2 conv, GroupNorm + ReLU, TF-SAME 3x3/2 max pool
    over zero padding) and bottleneck stages; returns every stage's map,
    shallowest first."""

    def __init__(self, embedding_size, hidden_sizes, depths, num_groups, width_factor,
                 dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.embedder = Container(
            convolution=_WSConv(3, embedding_size, 7, 2, **kw),
            norm=GroupNorm32(embedding_size, num_groups, 1e-5, device=device))
        stages, cin = [], embedding_size
        self.out_channels = []
        for s, (depth, hidden) in enumerate(zip(depths, hidden_sizes)):
            cout = _make_div(hidden * width_factor)
            stride = 1 if s == 0 else 2
            stages.append(Container(layers=nn.ModuleList(
                _BitBottleneck(cin if j == 0 else cout, cout, stride if j == 0 else 1,
                               num_groups, j == 0, **kw)
                for j in range(depth))))
            self.out_channels.append(cout)
            cin = cout
        self.encoder = Container(stages=nn.ModuleList(stages))

    def forward(self, x):
        h = F.relu(self.embedder.norm(self.embedder.convolution(x)))
        ph, pw = _same_pad(h.shape[1], 3, 2), _same_pad(h.shape[2], 3, 2)
        h = F.pad(h.permute(0, 3, 1, 2), (*pw, *ph))
        h = F.max_pool2d(h, 3, 2).permute(0, 2, 3, 1)
        feats = []
        for stage in self.encoder.stages:
            for layer in stage.layers:
                h = layer(h)
            feats.append(h)
        return feats


class DPTDepth(nn.Module):
    """HF-layout DPT depth estimator, pure ViT or (``is_hybrid``) the MiDaS
    hybrid.  Input: NHWC pixels already normalised ((x/255 - 0.5)/0.5), H
    and W multiples of ``patch_size``.  Output: [B, H, W] non-negative
    relative inverse depth (MiDaS' convention: larger is nearer)."""

    def __init__(self, hidden=1024, layers=24, heads=16, intermediate=4096,
                 patch_size=16, image_size=384,
                 backbone_out_indices: Sequence[int] = (5, 11, 17, 23),
                 neck_hidden_sizes: Sequence[int] = (256, 512, 1024, 1024),
                 reassemble_factors: Sequence[float] = (4, 2, 1, 0.5),
                 fusion_hidden_size=256, eps=1e-12, is_hybrid=False,
                 backbone_embedding_size=64,
                 backbone_hidden_sizes: Sequence[int] = (256, 512, 1024),
                 backbone_depths: Sequence[int] = (3, 4, 9), backbone_num_groups=32,
                 backbone_width_factor=1, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype, self.hidden, self.patch_size = dtype, hidden, patch_size
        self.image_size, self.is_hybrid = image_size, is_hybrid
        self.reassemble_factors = tuple(reassemble_factors)
        self.vit_indices = tuple(backbone_out_indices[2:] if is_hybrid
                                 else backbone_out_indices)
        grid0 = image_size // patch_size
        if is_hybrid:
            bit = _BitBackbone(backbone_embedding_size, backbone_hidden_sizes,
                               backbone_depths, backbone_num_groups,
                               backbone_width_factor, **kw)
            embeddings = Container(backbone=Container(bit=bit),
                                   projection=Linear(bit.out_channels[-1], hidden, **kw))
        else:
            embeddings = Container(patch_embeddings=Container(projection=Conv2d(
                3, hidden, patch_size, stride=patch_size, padding=0, **kw)))
        embeddings.cls_token = nn.Parameter(torch.zeros(1, 1, hidden, device=device))
        embeddings.position_embeddings = nn.Parameter(
            torch.zeros(1, grid0 * grid0 + 1, hidden, device=device))
        self.dpt = Container(embeddings=embeddings, encoder=Container(layer=nn.ModuleList(
            _ViTLayer(hidden, heads, intermediate, eps, **kw) for _ in range(layers))))

        readouts, reassemble, convs = {}, {}, {}
        for i, (nh, factor) in enumerate(zip(neck_hidden_sizes, self.reassemble_factors)):
            if is_hybrid and i <= 1:
                convs[str(i)] = Conv2d(bit.out_channels[i], fusion_hidden_size, bias=False,
                                       **kw)
                continue
            readouts[str(i)] = nn.ModuleList([Linear(2 * hidden, hidden, **kw)])
            layer = Container(projection=Linear(hidden, nh, **kw))
            if factor > 1:
                layer.resize = _TransposeUpsample(nh, int(factor), **kw)
            elif factor < 1:
                layer.resize = Conv2d(nh, nh, stride=int(round(1 / factor)), **kw)
            reassemble[str(i)] = layer
            convs[str(i)] = Conv2d(nh, fusion_hidden_size, bias=False, **kw)
        fusion = []
        for j in range(len(neck_hidden_sizes)):
            layer = Container(residual_layer2=_PreActResidual(fusion_hidden_size, **kw),
                              projection=Linear(fusion_hidden_size, fusion_hidden_size, **kw))
            if j:
                layer.residual_layer1 = _PreActResidual(fusion_hidden_size, **kw)
            fusion.append(layer)
        self.neck = Container(
            reassemble_stage=Container(readout_projects=Container(**readouts),
                                       layers=Container(**reassemble)),
            convs=Container(**convs),
            fusion_stage=Container(layers=nn.ModuleList(fusion)))
        self.head = Container(head=Container(**{
            "0": Conv2d(fusion_hidden_size, fusion_hidden_size // 2, **kw),
            "2": Conv2d(fusion_hidden_size // 2, 32, **kw),
            "4": Linear(32, 1, **kw)}))

    def _embed(self, pixel_values):
        emb = self.dpt.embeddings
        B, H, W, _ = pixel_values.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        x = pixel_values.to(self.dtype)
        bit_feats = None
        if self.is_hybrid:
            bit_feats = emb.backbone.bit(x)
            feat = bit_feats[-1]
            if tuple(feat.shape[1:3]) != (gh, gw):
                raise ValueError(f"BiT /16 feature map {tuple(feat.shape[1:3])} != patch "
                                 f"grid ({gh}, {gw}); input must be a multiple of 16")
            x = emb.projection(feat)
        else:
            x = emb.patch_embeddings.projection(x)
        x = x.reshape(B, gh * gw, self.hidden)
        pos = emb.position_embeddings
        grid0 = self.image_size // self.patch_size
        if (gh, gw) != (grid0, grid0):
            grid = _resize_half_pixel(pos[:, 1:].reshape(1, grid0, grid0, self.hidden), gh, gw)
            pos = torch.cat([pos[:, :1], grid.reshape(1, gh * gw, self.hidden)], dim=1)
        x = torch.cat([emb.cls_token.to(self.dtype).expand(B, 1, self.hidden), x], dim=1)
        return x + pos.to(self.dtype), bit_feats, (gh, gw)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x, bit_feats, (gh, gw) = self._embed(pixel_values)
        B = x.shape[0]
        taps = {}
        for i, layer in enumerate(self.dpt.encoder.layer):
            x = layer(x)
            if i in self.vit_indices:
                taps[i] = x
        neck = self.neck
        feats = []
        for i, factor in enumerate(self.reassemble_factors):
            conv = getattr(neck.convs, str(i))
            if self.is_hybrid and i <= 1:
                feats.append(conv(bit_feats[i]))
                continue
            h = taps[self.vit_indices[i - 2] if self.is_hybrid else self.vit_indices[i]]
            tokens = h[:, 1:]
            readout = h[:, :1].expand_as(tokens)
            h = getattr(neck.reassemble_stage.readout_projects, str(i))[0](
                torch.cat([tokens, readout], dim=-1))
            h = F.gelu(h).reshape(B, gh, gw, self.hidden)
            layer = getattr(neck.reassemble_stage.layers, str(i))
            h = layer.projection(h)
            if factor != 1:
                h = layer.resize(h)
            feats.append(conv(h))
        fused = None
        for layer, h in zip(neck.fusion_stage.layers, reversed(feats)):
            if fused is None:
                fused = h
            else:
                if fused.shape[1:3] != h.shape[1:3]:
                    h = _resize_half_pixel(h, fused.shape[1], fused.shape[2])
                fused = fused + layer.residual_layer1(h)
            fused = layer.residual_layer2(fused)
            fused = resize_bilinear_align_corners(fused, fused.shape[1] * 2,
                                                  fused.shape[2] * 2)
            fused = layer.projection(fused)
        head = self.head.head
        h = getattr(head, "0")(fused)
        h = resize_bilinear_align_corners(h, h.shape[1] * 2, h.shape[2] * 2)
        h = F.relu(getattr(head, "2")(h))
        return F.relu(getattr(head, "4")(h))[..., 0]


def dpt_overrides(cfg: dict) -> dict:
    """HF DPTConfig dict (config.json) -> DPTDepth kwargs: pure ViT, and the
    hybrid (``is_hybrid`` with a bottleneck BiT ``backbone_config``)."""
    if cfg.get("readout_type", "project") != "project":
        raise ValueError("only readout_type='project' is supported")
    out = dict(
        hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"],
        intermediate=cfg["intermediate_size"],
        patch_size=cfg["patch_size"],
        image_size=cfg["image_size"],
        backbone_out_indices=tuple(cfg["backbone_out_indices"]),
        neck_hidden_sizes=tuple(cfg["neck_hidden_sizes"]),
        reassemble_factors=tuple(cfg.get("reassemble_factors", (4, 2, 1, 0.5))),
        fusion_hidden_size=cfg["fusion_hidden_size"],
        eps=cfg.get("layer_norm_eps", 1e-12),
    )
    if cfg.get("is_hybrid"):
        bc = cfg.get("backbone_config") or {}
        if bc.get("layer_type", "bottleneck") != "bottleneck":
            raise ValueError("hybrid DPT needs a bottleneck BiT backbone "
                             f"(got layer_type={bc.get('layer_type')!r})")
        gp = (bc.get("global_padding") or "").upper()
        if gp != "SAME":
            raise ValueError(f"hybrid BiT requires global_padding='SAME', got {gp!r}")
        depths = tuple(bc.get("depths", (3, 4, 9)))
        out.update(
            is_hybrid=True,
            backbone_embedding_size=bc.get("embedding_size", 64),
            backbone_hidden_sizes=tuple(
                bc.get("hidden_sizes", (256, 512, 1024, 2048))[:len(depths)]),
            backbone_depths=depths,
            backbone_num_groups=bc.get("num_groups", 32),
            backbone_width_factor=bc.get("width_factor", 1),
        )
    return out
