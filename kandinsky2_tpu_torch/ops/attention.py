"""Attention swap point, the counterpart of ``kandinsky2_tpu/ops/attention.py``.

One routing rule, ``use_flash_kernel``, decides from dtype and shape
before the call, for the UNet's spatial attention (``qkv_attention``) and
the MoVQ ``AttnBlock`` alike:

* the flash-attention kernels (``FlashAttentionFunction``: K3 forward, K5
  and K4 backward) run when q, k and v are bf16 and the head dim is one
  the forward is built for (``SUPPORTED_HEAD_DIMS``), and, where a gradient
  is needed, one the backward is built for (``BACKWARD_HEAD_DIMS``);
* every other unmasked call, and every masked one, runs
  ``reference_attention``: the JAX package's ``_xla_attention``, q and k
  each pre-scaled by ch^-1/4, logits in the activation dtype, the
  additive mask and the softmax in fp32.

On a CPU tensor the same rule picks between the kernels' plain versions
and ``reference_attention``, so the CPU runs the card's routing.  The
rule never catches a kernel error: the kernel wrappers still raise for
what they do not take.  ``qkv_attention.plain_on_card`` counts the calls
on CUDA tensors that took ``reference_attention``, so a bf16 path can be
held to the kernels alone.

``added_kv_attention`` serves the 2.2 UNet's ``AddedKVAttention``
(``kandinsky2_tpu/models/unet22.py``), whose own semantics are K3's: fp32
logits with one 1/√d scale, fp32 softmax, P cast to v's dtype before P·V.
It takes the same route to the kernels; what they do not take runs
``added_kv_reference_attention``, those semantics in plain PyTorch, and
counts in the same ``qkv_attention.plain_on_card``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .flash_attention import BACKWARD_HEAD_DIMS, SUPPORTED_HEAD_DIMS, flash_attention


def use_flash_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether an unmasked call on q [B, T, H, d], k/v [B, S, H, d] goes to
    the flash-attention kernels."""
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        return False
    d = q.shape[-1]
    if d not in SUPPORTED_HEAD_DIMS:
        return False
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return not needs_grad or d in BACKWARD_HEAD_DIMS


def reference_attention(q, k, v, mask=None):
    """q: [B, T, H, c], k/v: [B, S, H, c]; mask additive [B, (H,) T, S] or
    None.  ``_xla_attention`` of the JAX package."""
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    logits = torch.einsum("bthc,bshc->bhts", q * scale, k * scale).float()
    if mask is not None:
        logits = logits + (mask[:, None] if mask.dim() == 3 else mask).float()
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshc->bthc", w, v)


def qkv_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention, q [B, T, H, c], k/v [B, S, H, c] -> [B, T, H, c]."""
    if mask is None and use_flash_kernel(q, k, v):
        return flash_attention(q, k, v)[0]
    if q.is_cuda:
        qkv_attention.plain_on_card += 1
    return reference_attention(q, k, v, mask)


qkv_attention.plain_on_card = 0


def added_kv_reference_attention(q, k, v):
    """q: [B, T, H, c], k/v: [B, S, H, c].  ``AddedKVAttention``'s attention
    in the JAX package: logits of the activations summed in fp32, one
    1/√c scale, fp32 softmax, P cast to v's dtype before P·V."""
    logits = torch.einsum("bthc,bshc->bhts", q.float(), k.float()) / math.sqrt(q.shape[-1])
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshc->bthc", w, v)


def added_kv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The 2.2 UNet's unmasked attention, q [B, T, H, c], k/v [B, S, H, c]
    (S = T + the image tokens): K3 where ``use_flash_kernel`` sends it,
    else ``added_kv_reference_attention``."""
    if use_flash_kernel(q, k, v):
        return flash_attention(q, k, v)[0]
    if q.is_cuda:
        qkv_attention.plain_on_card += 1
    return added_kv_reference_attention(q, k, v)
