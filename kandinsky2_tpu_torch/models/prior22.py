"""The Kandinsky 2.2 diffusion prior (the diffusers ``PriorTransformer``
layout) and the HF CLIP text tower with projection it is conditioned on,
the counterpart of ``kandinsky2_tpu/models/prior22.py``.

The prior is a 20-layer, 2048-wide transformer over the sequence of the 77
CLIP-bigG text tokens, the pooled text embedding, the timestep embedding,
the noised image embedding and a learned prd token (``embedding_order``),
predicting the normalised 1280-d image embedding at the prd token; the
``clip_mean`` and ``clip_std`` of the checkpoint are parameters.  Its
masked attention, like the text tower's causal one, stays on PyTorch's own
ops with the JAX package's semantics (fp32 logits and softmax).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Container, LayerNormF32, Linear
from .text_encoders import NEG_INF, _HFCLIPLayer, _mha, quick_gelu
from .unet22 import timestep_embedding_22


class BasicSelfBlock(nn.Module):
    """diffusers BasicTransformerBlock, self-attention only: pre-LN, exact
    GELU feed-forward."""

    def __init__(self, width, heads, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.norm1 = LayerNormF32(width, device=device)
        self.attn1 = Container(
            to_q=Linear(width, width, **kw), to_k=Linear(width, width, **kw),
            to_v=Linear(width, width, **kw),
            to_out=nn.ModuleList([Linear(width, width, **kw)]))
        self.norm3 = LayerNormF32(width, device=device)
        self.ff = Container(net=Container(**{
            "0": Container(proj=Linear(width, 4 * width, **kw)),
            "2": Linear(4 * width, width, **kw)}))

    def forward(self, x, mask=None):
        h = self.norm1(x)
        at = self.attn1
        x = x + at.to_out[0](_mha(at.to_q(h), at.to_k(h), at.to_v(h), self.heads, mask))
        net = self.ff.net
        h = F.gelu(getattr(net, "0").proj(self.norm3(x)))
        return x + getattr(net, "2")(h)


class PriorTransformer22(nn.Module):
    """diffusers PriorTransformer (the kandinsky-2-2-prior config): 32 heads
    of 64, 20 layers, embedding_dim 1280, 77 text embeddings."""

    def __init__(self, num_attention_heads=32, attention_head_dim=64, num_layers=20,
                 embedding_dim=1280, num_embeddings=77, additional_embeddings=4,
                 embedding_order=("text", "proj", "time", "x", "prd"),
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        W = num_attention_heads * attention_head_dim
        self.dtype = dtype
        self.inner_dim = W
        self.num_attention_heads = num_attention_heads
        self.embedding_dim = embedding_dim
        self.num_embeddings = num_embeddings
        self.embedding_order = tuple(embedding_order)
        self.time_embedding = Container(linear_1=Linear(W, W, **kw),
                                        linear_2=Linear(W, W, **kw))
        self.proj_in = Linear(embedding_dim, W, **kw)
        self.embedding_proj = Linear(embedding_dim, W, **kw)
        # the text tower's states are embedding_dim wide, as in every
        # published config
        self.encoder_hidden_states_proj = Linear(embedding_dim, W, **kw)
        self.positional_embedding = nn.Parameter(torch.zeros(
            1, num_embeddings + additional_embeddings, W, device=device))
        self.prd_embedding = nn.Parameter(torch.zeros(1, 1, W, device=device))
        self.transformer_blocks = nn.ModuleList(
            BasicSelfBlock(W, num_attention_heads, **kw) for _ in range(num_layers))
        self.norm_out = LayerNormF32(W, device=device)
        self.proj_to_clip_embeddings = Linear(W, embedding_dim, **kw)
        self.clip_mean = nn.Parameter(torch.zeros(1, embedding_dim, device=device))
        self.clip_std = nn.Parameter(torch.ones(1, embedding_dim, device=device))

    def forward(self, x, timesteps, proj_embedding, encoder_hidden_states, mask):
        """x: the noised, normalised image embedding [B, D]; proj_embedding:
        the pooled text embedding [B, D]; encoder_hidden_states [B, 77,
        D_text]; mask [B, 77] (True = keep).  Returns [B, D] fp32."""
        B = x.shape[0]
        dt = self.dtype
        te = self.time_embedding
        t_emb = te.linear_2(F.silu(te.linear_1(
            timestep_embedding_22(timesteps, self.inner_dim).to(dt))))
        pieces = {
            "text": self.encoder_hidden_states_proj(encoder_hidden_states.to(dt)),
            "proj": self.embedding_proj(proj_embedding.to(dt))[:, None],
            "time": t_emb[:, None],
            "x": self.proj_in(x.to(dt))[:, None],
            "prd": self.prd_embedding.to(dt).expand(B, 1, self.inner_dim),
        }
        ones = torch.ones((B, 1), dtype=torch.bool, device=x.device)
        keep = torch.cat([mask.bool() if k == "text" else ones
                          for k in self.embedding_order], dim=1)
        h = torch.cat([pieces[k] for k in self.embedding_order], dim=1)
        h = h + self.positional_embedding.to(dt)
        add_mask = torch.where(keep, 0.0, NEG_INF)[:, None, None, :]
        for blk in self.transformer_blocks:
            h = blk(h, add_mask)
        h = self.norm_out(h)
        # the prediction is read at the prd token's position
        order = self.embedding_order
        prd_end = sum(self.num_embeddings if k == "text" else 1
                      for k in order[:order.index("prd") + 1])
        return self.proj_to_clip_embeddings(h[:, prd_end - 1]).float()

    def post_process(self, latents):
        return latents * self.clip_std + self.clip_mean


class HFCLIPText(nn.Module):
    """HF ``CLIPTextModelWithProjection`` layout (the 2.2 prior's text
    encoder; the defaults are bigG's: width 1280, 32 layers, 20 heads,
    exact GELU).  Returns (last_hidden_state fp32, the projected embedding
    at the first ``eot_token_id`` of each row, fp32)."""

    def __init__(self, vocab_size=49408, context_length=77, hidden=1280, layers=32,
                 heads=20, intermediate=5120, projection_dim=1280, act="gelu",
                 eps=1e-5, eot_token_id=49407, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.context_length = context_length
        self.hidden = hidden
        self.eot_token_id = eot_token_id
        act_fn = quick_gelu if act == "quick_gelu" else F.gelu
        self.text_model = Container(
            embeddings=Container(
                token_embedding=nn.Embedding(vocab_size, hidden, device=device),
                position_embedding=nn.Embedding(context_length, hidden, device=device)),
            encoder=Container(layers=nn.ModuleList(
                _HFCLIPLayer(hidden, heads, intermediate, act_fn, eps, dtype, device)
                for _ in range(layers))),
            final_layer_norm=LayerNormF32(hidden, eps, device=device))
        self.text_projection = Linear(hidden, projection_dim, bias=False, device=device)

    def forward(self, tokens):
        tm = self.text_model
        L = tokens.shape[1]
        x = tm.embeddings.token_embedding(tokens).to(self.dtype)
        pos = torch.arange(L, device=tokens.device)
        x = x + tm.embeddings.position_embedding(pos).to(x.dtype)[None]
        causal = torch.triu(torch.full((L, L), NEG_INF, device=x.device), diagonal=1)
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        x = tm.final_layer_norm(x)
        eot = (tokens == self.eot_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return x.float(), self.text_projection(pooled.float())
