"""DALL·E-2-style diffusion prior, the counterpart of
``kandinsky2_tpu/models/prior.py``: ``PriorTransformer`` (a causal
transformer with a padding mask over [text tokens, pooled text, timestep,
noised image embedding, prd token]) and ``prior_sample_fn`` (classifier-free
guidance, clamp to ±10, de-normalisation).  Its attention is masked, so it
stays plain PyTorch: logits in fp32 from ch^-1/4 pre-scaled q and k.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..diffusion import MeanType, Schedule, VarType, p_sample_loop
from .layers import Container, LayerNormF32, Linear, timestep_embedding


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block (prior.py:106-127), fused per-head [q|k|v]."""

    def __init__(self, width, heads, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.ln_1 = LayerNormF32(width, device=device)
        self.attn = Container(
            c_qkv=Linear(width, 3 * width, **kw),
            c_proj=Linear(width, width, **kw),
        )
        self.ln_2 = LayerNormF32(width, device=device)
        self.mlp = Container(
            c_fc=Linear(width, 4 * width, **kw),
            c_proj=Linear(4 * width, width, **kw),
        )

    def forward(self, x, mask=None):
        B, T, W = x.shape
        ch = W // self.heads
        qkv = self.attn.c_qkv(self.ln_1(x)).reshape(B, T, self.heads, 3 * ch)
        q, k, v = qkv.split(ch, dim=-1)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        logits = torch.einsum("bthc,bshc->bhts", (q * scale).float(),
                              (k * scale).float())
        if mask is not None:
            logits = logits + mask[:, None].float()
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        a = torch.einsum("bhts,bshc->bthc", w, v).reshape(B, T, W)
        x = x + self.attn.c_proj(a)
        h = F.gelu(self.mlp.c_fc(self.ln_2(x)))
        return x + self.mlp.c_proj(h)


class PriorTransformer(nn.Module):
    """prior.py:159-270.  ``forward(x, timesteps, text_emb, text_enc, mask)``
    with x the noised CLIP image embedding [B, clip_dim]."""

    EXT_LEN = 4

    def __init__(self, text_ctx=77, xf_width=2048, xf_layers=20, xf_heads=32,
                 xf_final_ln=True, clip_dim=768, clip_xf_width=768,
                 dtype=torch.float32, device=None):
        super().__init__()
        W = xf_width
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.text_ctx = text_ctx
        self.xf_width = W
        self.time_embed = nn.ModuleList([
            Linear(W, W, **kw), nn.SiLU(), Linear(W, W, **kw),
        ])
        self.text_enc_proj = Linear(clip_xf_width, W, **kw)
        self.text_emb_proj = Linear(clip_dim, W, **kw)
        self.clip_img_proj = Linear(clip_dim, W, **kw)
        self.out_proj = Linear(W, clip_dim, **kw)
        self.transformer = Container(resblocks=nn.ModuleList(
            ResidualAttentionBlock(W, xf_heads, dtype, device)
            for _ in range(xf_layers)
        ))
        self.final_ln = LayerNormF32(W, device=device) if xf_final_ln else None
        self.positional_embedding = nn.Parameter(
            torch.zeros(1, text_ctx + self.EXT_LEN, W, device=device))
        self.prd_emb = nn.Parameter(torch.zeros(1, 1, W, device=device))

    def forward(self, x, timesteps, text_emb, text_enc, mask):
        B = x.shape[0]
        dt = self.dtype
        S = self.text_ctx + self.EXT_LEN
        mask = F.pad(mask.bool(), (0, self.EXT_LEN), value=True)
        t_emb = self.time_embed[2](F.silu(
            self.time_embed[0](timestep_embedding(timesteps, self.xf_width))))
        seq = torch.cat([
            self.text_enc_proj(text_enc.to(dt)),
            self.text_emb_proj(text_emb.to(dt))[:, None],
            t_emb[:, None],
            self.clip_img_proj(x.to(dt))[:, None],
            self.prd_emb.to(dt).expand(B, 1, self.xf_width),
        ], dim=1)
        h = seq + self.positional_embedding.to(dt)
        causal = torch.triu(
            torch.full((S, S), float("-inf"), device=x.device), diagonal=1
        )
        pad = torch.zeros(mask.shape, device=x.device).masked_fill(
            ~mask, float("-inf"))
        add_mask = pad[:, None, :] + causal[None]
        for blk in self.transformer.resblocks:
            h = blk(h, add_mask)
        if self.final_ln is not None:
            h = self.final_ln(h)
        return self.out_proj(h[:, -1]).float()


def prior_sample_fn(
    prior: PriorTransformer,
    sched: Schedule,
    txt_feat: torch.Tensor,
    txt_feat_seq: torch.Tensor,
    mask: torch.Tensor,
    cf_guidance_scale: float,
    clip_mean: torch.Tensor,
    clip_std: torch.Tensor,
    x_T: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    noise_seq: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample a CLIP image embedding from the prior (prior.py:336-384).
    ``txt_feat``/``txt_feat_seq``/``mask`` are the CFG-doubled [cond; uncond]
    batch 2B; the sampler carries B and the model closure doubles x.
    Returns the de-normalised cond-half embedding [B, clip_dim]."""
    bsz = txt_feat.shape[0] // 2
    clip_dim = clip_mean.shape[-1]

    def model_fn(x, t_model):
        out = prior(torch.cat([x, x]), torch.cat([t_model, t_model]),
                    text_emb=txt_feat, text_enc=txt_feat_seq, mask=mask)
        eps = out[:, :clip_dim]
        cond_eps, uncond_eps = eps[:bsz], eps[bsz:]
        return uncond_eps + cf_guidance_scale * (cond_eps - uncond_eps)

    sample = p_sample_loop(
        model_fn, sched, x_T, generator,
        mean_type=MeanType.START_X, var_type=VarType.FIXED_SMALL,
        denoised_fn=lambda v: torch.clamp(v, -10.0, 10.0),
        noise_seq=noise_seq,
    )
    return sample * clip_std + clip_mean
