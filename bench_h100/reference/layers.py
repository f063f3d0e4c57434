"""Plain fp32 building blocks of the reference: NHWC images, [B, T, C]
sequences, every matmul and convolution in float32 with TF32 off
(``exact_fp32``), no kernel of the program.

``set_fp8(module)`` turns the module's linear layers and convolutions into
the control of the correctness check: each rounds its input and its weight
to float8 e4m3 (one scale per tensor, its largest magnitude mapped to 448)
before the fp32 product, the precision a later change would be tempted
to serve the bf16 models in.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0
NEG_INF = torch.finfo(torch.float32).min


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor, in fp32;
    the gradient passes straight through (fp8 forward operands, an fp32
    backward)."""
    t = t.float()
    scale = FP8_MAX / t.detach().abs().amax().clamp(min=1e-30)
    q = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q - t.detach())


@contextlib.contextmanager
def exact_fp32():
    """fp32 products in full fp32 precision: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


class Linear(nn.Linear):
    """y = x Wᵀ + b over the last axis, fp32."""

    fp8 = False

    def forward(self, x):
        x, w = x.float(), self.weight.float()
        if self.fp8:
            x, w = fake_fp8(x), fake_fp8(w)
        return F.linear(x, w, None if self.bias is None else self.bias.float())


class Conv2d(nn.Conv2d):
    """Conv2d on NHWC tensors, fp32."""

    fp8 = False

    def __init__(self, in_channels, out_channels, kernel=3, stride=1, padding=1,
                 bias=True, device=None):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=padding, bias=bias, device=device)

    def forward(self, x):
        x, w = x.float(), self.weight.float()
        if self.fp8:
            x, w = fake_fp8(x), fake_fp8(w)
        b = None if self.bias is None else self.bias.float()
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


def set_fp8(module: nn.Module, on: bool = True) -> nn.Module:
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d)):
            m.fp8 = on
    return module


class GroupNorm32(nn.Module):
    """GroupNorm over the channel (last) axis, then the FiLM
    ``y·(1 + scale) + shift`` and ``y·sigmoid(swish·y)`` where swish is not 0."""

    def __init__(self, channels, num_groups=32, eps=1e-5, swish=0.0, device=None):
        super().__init__()
        self.num_groups, self.eps, self.swish = num_groups, eps, swish
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x, film=None):
        shape = x.shape
        B, C = shape[0], shape[-1]
        x3 = x.float().reshape(B, -1, C).transpose(1, 2)
        y = F.group_norm(x3, self.num_groups, self.weight.float(), self.bias.float(),
                         self.eps).transpose(1, 2).reshape(shape)
        if film is not None:
            scale, shift = (f.float().reshape(B, *([1] * (len(shape) - 2)), C)
                            for f in film)
            y = y * (1.0 + scale) + shift
        if self.swish:
            y = y * torch.sigmoid(self.swish * y)
        return y


class LayerNormF32(nn.Module):
    def __init__(self, channels, eps=1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                            self.bias.float(), self.eps)


class Container(nn.Module):
    """Named holder of submodules, for dotted state_dict paths."""

    def __init__(self, /, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


def attention(q, k, v, mask=None):
    """softmax(q kᵀ/√d + mask) v; q [B, T, H, d], k/v [B, S, H, d], fp32.
    ``mask`` is additive, broadcast against [B, H, T, S]."""
    logits = torch.einsum("bthc,bshc->bhts", q.float(), k.float()) / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = logits + mask
    return torch.einsum("bhts,bshc->bthc", torch.softmax(logits, dim=-1), v.float())


def mha(q, k, v, heads, mask=None):
    """``attention`` on [B, T, W] projections split into ``heads``."""
    B, T, W = q.shape
    split = lambda t: t.reshape(B, t.shape[1], heads, W // heads)
    return attention(split(q), split(k), split(v), mask).reshape(B, T, W)


def timestep_embedding(timesteps, dim, max_period=10000.0, sin_first=False):
    """Sinusoidal embedding, [cos, sin] (2.1) or [sin, cos] (2.2)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    parts = [torch.sin(args), torch.cos(args)] if sin_first else [torch.cos(args),
                                                                 torch.sin(args)]
    return torch.cat(parts, dim=-1)


def upsample_nearest_2x(x):
    B, H, W, C = x.shape
    return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)


def avg_pool_2x(x):
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))
