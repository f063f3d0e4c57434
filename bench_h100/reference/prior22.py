"""The Kandinsky 2.2 prior (diffusers PriorTransformer), fp32."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import NEG_INF, Container, LayerNormF32, Linear, mha, timestep_embedding


class BasicSelfBlock(nn.Module):
    """Pre-LN self-attention and an exact-GELU feed-forward."""

    def __init__(self, width, heads, device=None):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNormF32(width, device=device)
        self.attn1 = Container(
            to_q=Linear(width, width, device=device), to_k=Linear(width, width, device=device),
            to_v=Linear(width, width, device=device),
            to_out=nn.ModuleList([Linear(width, width, device=device)]))
        self.norm3 = LayerNormF32(width, device=device)
        self.ff = Container(net=Container(**{
            "0": Container(proj=Linear(width, 4 * width, device=device)),
            "2": Linear(4 * width, width, device=device)}))

    def forward(self, x, mask):
        h = self.norm1(x)
        at = self.attn1
        x = x + at.to_out[0](mha(at.to_q(h), at.to_k(h), at.to_v(h), self.heads, mask))
        net = self.ff.net
        return x + getattr(net, "2")(F.gelu(getattr(net, "0").proj(self.norm3(x))))


class PriorTransformer22(nn.Module):
    """The sequence [77 text states, pooled text, time, x, prd] through the
    transformer; the prediction is read at the prd token."""

    def __init__(self, num_attention_heads, attention_head_dim, num_layers, embedding_dim,
                 num_embeddings, additional_embeddings, device=None):
        super().__init__()
        W = num_attention_heads * attention_head_dim
        self.inner_dim = W
        self.embedding_dim = embedding_dim
        self.num_embeddings = num_embeddings
        self.time_embedding = Container(linear_1=Linear(W, W, device=device),
                                        linear_2=Linear(W, W, device=device))
        self.proj_in = Linear(embedding_dim, W, device=device)
        self.embedding_proj = Linear(embedding_dim, W, device=device)
        self.encoder_hidden_states_proj = Linear(embedding_dim, W, device=device)
        self.positional_embedding = nn.Parameter(torch.zeros(
            1, num_embeddings + additional_embeddings, W, device=device))
        self.prd_embedding = nn.Parameter(torch.zeros(1, 1, W, device=device))
        self.transformer_blocks = nn.ModuleList(
            BasicSelfBlock(W, num_attention_heads, device) for _ in range(num_layers))
        self.norm_out = LayerNormF32(W, device=device)
        self.proj_to_clip_embeddings = Linear(W, embedding_dim, device=device)
        self.clip_mean = nn.Parameter(torch.zeros(1, embedding_dim, device=device))
        self.clip_std = nn.Parameter(torch.ones(1, embedding_dim, device=device))

    def forward(self, x, timesteps, proj_embedding, encoder_hidden_states, mask):
        B = x.shape[0]
        te = self.time_embedding
        t_emb = te.linear_2(F.silu(te.linear_1(
            timestep_embedding(timesteps, self.inner_dim, sin_first=True))))
        h = torch.cat([
            self.encoder_hidden_states_proj(encoder_hidden_states),
            self.embedding_proj(proj_embedding)[:, None], t_emb[:, None],
            self.proj_in(x)[:, None],
            self.prd_embedding.float().expand(B, 1, self.inner_dim)], dim=1)
        h = h + self.positional_embedding.float()
        keep = torch.cat([mask.bool(), torch.ones((B, 4), dtype=torch.bool,
                                                  device=x.device)], dim=1)
        add = torch.where(keep, 0.0, NEG_INF)[:, None, None, :]
        for blk in self.transformer_blocks:
            h = blk(h, add)
        return self.proj_to_clip_embeddings(self.norm_out(h)[:, -1])
