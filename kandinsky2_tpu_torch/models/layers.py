"""Shared NN primitives, channels-last (NHWC), the counterpart of
``kandinsky2_tpu/models/layers.py``.

Conventions, as in the JAX package:

* Image tensors are NHWC and sequences [B, T, C].  A 3x3 conv permutes to an
  NCHW view of the same memory (channels_last strides), so convolutions run
  in the channels-last layout without copies.
* Parameters are created in float32; ``dtype`` is the compute dtype, and a
  layer casts its input and parameters to it (a no-op once the parameters
  are stored in that dtype).
* ``Linear`` takes the place of flax ``Dense`` for linear layers and 1x1
  convolutions; ``GroupNorm32`` and ``LayerNormF32`` keep fp32 statistics.
* Submodules carry the reference state_dict names, so the JAX package's
  parameter paths map onto them mechanically (``weights/from_jax.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.group_norm import group_norm


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding in [cos, sin] order (nn.py:101-121);
    fp32 output."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Linear(nn.Linear):
    """Linear layer / 1x1 conv over the last axis, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Conv2d):
    """Conv2d on NHWC tensors (torch Conv2d(padding=int) semantics)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, padding: int = 1, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=padding, bias=bias, device=device)
        # channels-last weights match the NHWC activations, so the conv does
        # not re-layout its weight on every call
        self.weight.data = self.weight.data.to(memory_format=torch.channels_last)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), b,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class GroupNorm32(nn.Module):
    """GroupNorm over the channel (last) axis with fp32 one-pass moments
    (shifted by each group's first element, ``ops/group_norm.py``), an
    optional FiLM ``norm(x)·(1+scale)+shift`` folded into the coefficients,
    and optional SiLU (nn.py:26-37).  Runs the GroupNorm kernel pair
    (``ops/group_norm.py``) on a CUDA tensor."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 swish: float = 0.0, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.swish = swish
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x, film: Optional[tuple] = None):
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps,
                          swish=self.swish, film=film)


class LayerNormF32(nn.Module):
    """LayerNorm with fp32 statistics, cast back to the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class Container(nn.Module):
    """Named holder of submodules, for dotted state_dict paths such as
    ``mid.block_1`` or ``attn.c_qkv``."""

    def __init__(self, /, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample, NHWC."""
    B, H, W, C = x.shape
    return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(
        B, 2 * H, 2 * W, C
    )


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize, NHWC, with F.interpolate's index math
    src = floor(dst · in/out); an identity-size resize returns x."""
    B, H, W, C = x.shape
    if (H, W) == tuple(size):
        return x
    h_idx = (torch.arange(size[0], dtype=torch.float32, device=x.device)
             * (H / size[0])).long()
    w_idx = (torch.arange(size[1], dtype=torch.float32, device=x.device)
             * (W / size[1])).long()
    return x[:, h_idx][:, :, w_idx]


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize to (H, W), NHWC (half-pixel centres, the edge pixel
    repeated: ``F.interpolate`` with align_corners=False).  It equals the
    JAX package's ``jax.image.resize`` "linear" when it upsamples, the only
    way the super-resolution UNets call it; ``jax.image.resize``
    antialiases when it shrinks and this does not."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, NHWC."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))


class AttentionPooling(nn.Module):
    """Multi-head attention pooling (reference text_encoders.py:24-58):
    unmasked q/k/v self-attention over the whole sequence with fp32 logits
    and softmax, position 0 of the projected output.  ``x_dim`` is the
    input width where it differs from ``in_dim`` (flax infers it)."""

    def __init__(self, heads: int, in_dim: int, out_dim: int,
                 x_dim: Optional[int] = None, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        x_dim = x_dim or in_dim
        self.q_linear = Linear(x_dim, in_dim, **kw)
        self.k_linear = Linear(x_dim, in_dim, **kw)
        self.v_linear = Linear(x_dim, in_dim, **kw)
        self.out = Linear(in_dim, out_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        q, k, v = (lin(x) for lin in (self.q_linear, self.k_linear, self.v_linear))
        d_k = q.shape[-1] // self.heads
        q, k, v = (t.reshape(B, T, self.heads, d_k) for t in (q, k, v))
        logits = torch.einsum("bthc,bshc->bhts", q.float(), k.float()) / math.sqrt(d_k)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhts,bshc->bthc", w, v).reshape(B, T, -1)
        return self.out(out)[:, 0]
