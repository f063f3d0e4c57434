"""T5/MT5 encoder tower (HF layout), the counterpart of
``kandinsky2_tpu/models/t5.py``: the 2.0 pipeline's second text stream, an
mT5-small encoder by default.  T5 semantics: RMSNorm, unscaled attention
with an additive relative-position bias from block 0's table, the
``finfo(float32).min`` key mask, gated-GELU (tanh approximation) feed
forward, no biases, a final RMSNorm.  Its attention is masked and short,
so it stays plain PyTorch with fp32 logits and softmax.  Module names are
the HF state_dict's (``shared``, ``encoder.block.{i}.layer.{0,1}.*``,
``encoder.final_layer_norm``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Container, Linear


class RMSNorm(nn.Module):
    """x · rsqrt(mean(x²) + eps) · weight in fp32, cast back to x's dtype."""

    def __init__(self, channels: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))

    def forward(self, x):
        y = x.float()
        y = y * torch.rsqrt(y.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def relative_position_bucket(rel: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 bucket of each relative distance (memory − query),
    int64; the log bucket in float32 as the JAX package takes it."""
    num_buckets //= 2
    ret = (rel > 0).long() * num_buckets
    n = rel.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).long()
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


def _t5_layer(d_model, inner, d_ff, num_heads, rel_buckets, eps, first, kw, device):
    attn = Container(q=Linear(d_model, inner, bias=False, **kw),
                     k=Linear(d_model, inner, bias=False, **kw),
                     v=Linear(d_model, inner, bias=False, **kw),
                     o=Linear(inner, d_model, bias=False, **kw))
    if first:  # the one bias table, shared by every block
        attn.relative_attention_bias = nn.Embedding(rel_buckets, num_heads,
                                                    device=device)
    ff = Container(wi_0=Linear(d_model, d_ff, bias=False, **kw),
                   wi_1=Linear(d_model, d_ff, bias=False, **kw),
                   wo=Linear(d_ff, d_model, bias=False, **kw))
    return Container(layer=nn.ModuleList([
        Container(SelfAttention=attn, layer_norm=RMSNorm(d_model, eps, device)),
        Container(DenseReluDense=ff, layer_norm=RMSNorm(d_model, eps, device)),
    ]))


class T5Encoder(nn.Module):
    """(input_ids [B, T], attention_mask [B, T]) -> last_hidden_state
    [B, T, d_model]."""

    def __init__(self, vocab_size=250112, d_model=512, d_kv=64, d_ff=1024,
                 num_layers=8, num_heads=6, rel_buckets=32, rel_max_distance=128,
                 eps=1e-6, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.num_heads, self.d_kv = num_heads, d_kv
        self.rel_buckets, self.rel_max_distance = rel_buckets, rel_max_distance
        inner = num_heads * d_kv
        self.shared = nn.Embedding(vocab_size, d_model, device=device)
        self.encoder = Container(
            block=nn.ModuleList(
                _t5_layer(d_model, inner, d_ff, num_heads, rel_buckets, eps, i == 0,
                          kw, device)
                for i in range(num_layers)),
            final_layer_norm=RMSNorm(d_model, eps, device),
        )

    def position_bias(self, T: int, attention_mask: torch.Tensor) -> torch.Tensor:
        """[B, H, T, T] fp32: block 0's bias table at the buckets of
        memory − query plus the key mask.  The buckets are computed on the
        CPU, so every device takes the same table."""
        pos = torch.arange(T)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], self.rel_buckets,
                                           self.rel_max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
        bias = table(buckets.to(table.weight.device)).float().permute(2, 0, 1)[None]
        key_mask = (1.0 - attention_mask.float())[:, None, None, :]
        return bias + key_mask * torch.finfo(torch.float32).min

    def forward(self, input_ids, attention_mask):
        B, T = input_ids.shape
        H, c = self.num_heads, self.d_kv
        x = self.shared(input_ids).to(self.dtype)
        bias = self.position_bias(T, attention_mask)
        for block in self.encoder.block:
            sa, ff = block.layer
            h = sa.layer_norm(x)
            q, k, v = (lin(h).reshape(B, T, H, c)
                       for lin in (sa.SelfAttention.q, sa.SelfAttention.k,
                                   sa.SelfAttention.v))
            # unscaled logits, the bias additive
            logits = torch.einsum("bthc,bshc->bhts", q.float(), k.float()) + bias
            w = torch.softmax(logits, dim=-1).to(v.dtype)
            a = torch.einsum("bhts,bshc->bthc", w, v).reshape(B, T, H * c)
            x = x + sa.SelfAttention.o(a)
            h = ff.layer_norm(x)
            dr = ff.DenseReluDense
            h = F.gelu(dr.wi_0(h), approximate="tanh") * dr.wi_1(h)
            x = x + dr.wo(h)
        return self.encoder.final_layer_norm(x)
