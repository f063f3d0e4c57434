"""Attention swap point, the counterpart of ``kandinsky2_tpu/ops/attention.py``.

Unmasked calls (the UNet's spatial attention with the encoder tokens
prepended to K/V) go to ``FlashAttentionFunction``: the flash-attention
kernels forward and backward on a CUDA tensor, and their plain versions on
the CPU.  Masked calls stay plain PyTorch with the JAX
package's semantics: q and k each pre-scaled by ch^-1/4, logits in the
activation dtype, the additive mask and the softmax in fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .flash_attention import flash_attention


def masked_attention(q, k, v, mask):
    """q: [B, T, H, c], k/v: [B, S, H, c]; mask additive [B, (H,) T, S]."""
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    logits = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
    if mask.dim() == 3:
        mask = mask[:, None]
    w = torch.softmax(logits.float() + mask.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshc->bthc", w, v)


def qkv_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention, q [B, T, H, c], k/v [B, S, H, c] -> [B, T, H, c]."""
    if mask is None:
        return flash_attention(q, k, v)[0]
    return masked_attention(q, k, v, mask)
