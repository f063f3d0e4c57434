"""The frozen towers, fp32: the CLIP-bigG text tower with projection and
the ViT-bigG image tower of 2.2 (HF layouts), and the XLM-R +
MultilingualCLIP text encoder and the OpenAI CLIP ViT-L/14 image tower of
2.1.  Parameter names are the published checkpoints' state_dict names."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import NEG_INF, Conv2d, Container, LayerNormF32, Linear, mha


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class HFCLIPLayer(nn.Module):
    """HF CLIPEncoderLayer: pre-LN, q/k/v projections, MLP with ``act``."""

    def __init__(self, hidden, heads, intermediate, act=F.gelu, eps=1e-5, device=None):
        super().__init__()
        self.heads, self.act = heads, act
        self.layer_norm1 = LayerNormF32(hidden, eps, device=device)
        self.self_attn = Container(
            q_proj=Linear(hidden, hidden, device=device),
            k_proj=Linear(hidden, hidden, device=device),
            v_proj=Linear(hidden, hidden, device=device),
            out_proj=Linear(hidden, hidden, device=device))
        self.layer_norm2 = LayerNormF32(hidden, eps, device=device)
        self.mlp = Container(fc1=Linear(hidden, intermediate, device=device),
                             fc2=Linear(intermediate, hidden, device=device))

    def forward(self, x, mask=None):
        h = self.layer_norm1(x)
        at = self.self_attn
        x = x + at.out_proj(mha(at.q_proj(h), at.k_proj(h), at.v_proj(h), self.heads,
                                mask))
        return x + self.mlp.fc2(self.act(self.mlp.fc1(self.layer_norm2(x))))


class HFCLIPText(nn.Module):
    """CLIPTextModelWithProjection: causal tower, final LN, the projection
    of the state at the first end-of-text token.  Returns (states, pooled)."""

    def __init__(self, vocab_size, context_length, hidden, layers, heads, intermediate,
                 projection_dim, eot_token_id, act=F.gelu, eps=1e-5, device=None):
        super().__init__()
        self.context_length = context_length
        self.eot_token_id = eot_token_id
        self.text_model = Container(
            embeddings=Container(
                token_embedding=nn.Embedding(vocab_size, hidden, device=device),
                position_embedding=nn.Embedding(context_length, hidden, device=device)),
            encoder=Container(layers=nn.ModuleList(
                HFCLIPLayer(hidden, heads, intermediate, act, eps, device)
                for _ in range(layers))),
            final_layer_norm=LayerNormF32(hidden, eps, device=device))
        self.text_projection = Linear(hidden, projection_dim, bias=False, device=device)

    def forward(self, tokens):
        tm = self.text_model
        L = tokens.shape[1]
        pos = torch.arange(L, device=tokens.device)
        x = (tm.embeddings.token_embedding(tokens).float()
             + tm.embeddings.position_embedding(pos).float()[None])
        causal = torch.triu(torch.full((L, L), NEG_INF, device=x.device), diagonal=1)
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        x = tm.final_layer_norm(x)
        eot = (tokens == self.eot_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return x, self.text_projection(pooled)


class HFCLIPVision(nn.Module):
    """CLIPVisionModelWithProjection on NHWC images already normalised."""

    def __init__(self, image_size, patch_size, hidden, layers, heads, intermediate,
                 projection_dim, act=F.gelu, eps=1e-5, device=None):
        super().__init__()
        self.hidden = hidden
        self.image_size = image_size
        embeddings = Container(
            patch_embedding=Conv2d(3, hidden, patch_size, stride=patch_size, padding=0,
                                   bias=False, device=device),
            position_embedding=nn.Embedding((image_size // patch_size) ** 2 + 1, hidden,
                                            device=device))
        embeddings.class_embedding = nn.Parameter(torch.zeros(hidden, device=device))
        self.vision_model = Container(
            embeddings=embeddings,
            pre_layrnorm=LayerNormF32(hidden, eps, device=device),
            encoder=Container(layers=nn.ModuleList(
                HFCLIPLayer(hidden, heads, intermediate, act, eps, device)
                for _ in range(layers))),
            post_layernorm=LayerNormF32(hidden, eps, device=device))
        self.visual_projection = Linear(hidden, projection_dim, bias=False, device=device)

    def forward(self, images):
        vm = self.vision_model
        B = images.shape[0]
        x = vm.embeddings.patch_embedding(images).reshape(B, -1, self.hidden)
        cls = vm.embeddings.class_embedding.float().expand(B, 1, self.hidden)
        x = torch.cat([cls, x], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        x = vm.pre_layrnorm(x + vm.embeddings.position_embedding(pos).float()[None])
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


class BertLayer(nn.Module):
    """Post-LN RoBERTa encoder layer, exact GELU."""

    def __init__(self, hidden, heads, intermediate, eps=1e-5, device=None):
        super().__init__()
        self.heads = heads
        self.attention = Container(
            self=Container(query=Linear(hidden, hidden, device=device),
                           key=Linear(hidden, hidden, device=device),
                           value=Linear(hidden, hidden, device=device)),
            output=Container(dense=Linear(hidden, hidden, device=device),
                             LayerNorm=LayerNormF32(hidden, eps, device=device)))
        self.intermediate = Container(dense=Linear(hidden, intermediate, device=device))
        self.output = Container(dense=Linear(intermediate, hidden, device=device),
                                LayerNorm=LayerNormF32(hidden, eps, device=device))

    def forward(self, x, mask):
        att = self.attention
        a = mha(att.self.query(x), att.self.key(x), att.self.value(x), self.heads, mask)
        x = att.output.LayerNorm(x + att.output.dense(a))
        return self.output.LayerNorm(
            x + self.output.dense(F.gelu(self.intermediate.dense(x))))


class XLMRobertaEncoder(nn.Module):
    """XLM-R: position ids cumsum(mask)·mask + padding_idx."""

    def __init__(self, vocab_size, hidden, layers, heads, intermediate, max_positions,
                 pad_token_id=1, eps=1e-5, device=None):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.embeddings = Container(
            word_embeddings=nn.Embedding(vocab_size, hidden, device=device),
            position_embeddings=nn.Embedding(max_positions, hidden, device=device),
            token_type_embeddings=nn.Embedding(1, hidden, device=device),
            LayerNorm=LayerNormF32(hidden, eps, device=device))
        self.encoder = Container(layer=nn.ModuleList(
            BertLayer(hidden, heads, intermediate, eps, device) for _ in range(layers)))

    def forward(self, input_ids, attention_mask):
        mask = attention_mask.long()
        pos_ids = torch.cumsum(mask, dim=1) * mask + self.pad_token_id
        e = self.embeddings
        h = e.LayerNorm(e.word_embeddings(input_ids).float()
                        + e.position_embeddings(pos_ids).float()
                        + e.token_type_embeddings(torch.zeros_like(input_ids)).float())
        add = (1.0 - attention_mask.float())[:, None, None, :] * NEG_INF
        for layer in self.encoder.layer:
            h = layer(h, add)
        return h


class MultilingualCLIP(nn.Module):
    """XLM-R, the masked mean, a linear head: (pooled projection, states)."""

    def __init__(self, out_features, vocab_size, hidden, layers, heads, intermediate,
                 max_positions, device=None):
        super().__init__()
        self.transformer = XLMRobertaEncoder(vocab_size, hidden, layers, heads,
                                             intermediate, max_positions, device=device)
        self.LinearTransformation = Linear(hidden, out_features, device=device)

    def forward(self, input_ids, attention_mask):
        embs = self.transformer(input_ids, attention_mask)
        m = attention_mask.float()[:, :, None]
        return self.LinearTransformation((embs * m).sum(1) / m.sum(1)), embs


class TextEncoder(nn.Module):
    """The 2.1 text encoder ('multiclip'): (full states, pooled)."""

    def __init__(self, in_features, out_features, layers, heads, intermediate,
                 vocab_size, max_positions, device=None):
        super().__init__()
        self.max_positions = max_positions
        self.model = MultilingualCLIP(out_features, vocab_size, in_features, layers, heads,
                                      intermediate, max_positions, device=device)

    def forward(self, tokens, mask):
        pooled, full = self.model(tokens, mask)
        return full, pooled


class CLIPResBlock(nn.Module):
    """OpenAI CLIP block: pre-LN, fused in_proj, QuickGELU MLP."""

    def __init__(self, width, heads, device=None):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNormF32(width, device=device)
        self.attn = Container(in_proj=Linear(width, 3 * width, device=device),
                              out_proj=Linear(width, width, device=device))
        self.ln_2 = LayerNormF32(width, device=device)
        self.mlp = Container(c_fc=Linear(width, 4 * width, device=device),
                             c_proj=Linear(4 * width, width, device=device))

    def forward(self, x):
        q, k, v = self.attn.in_proj(self.ln_1(x)).chunk(3, dim=-1)
        x = x + self.attn.out_proj(mha(q, k, v, self.heads))
        return x + self.mlp.c_proj(quick_gelu(self.mlp.c_fc(self.ln_2(x))))


class CLIPViT(nn.Module):
    """OpenAI CLIP ``encode_image`` on NHWC images already normalised."""

    def __init__(self, image_size, patch_size, width, layers, heads, embed_dim,
                 device=None):
        super().__init__()
        self.width = width
        self.conv1 = Conv2d(3, width, patch_size, stride=patch_size, padding=0,
                            bias=False, device=device)
        self.class_embedding = nn.Parameter(torch.zeros(width, device=device))
        self.positional_embedding = nn.Parameter(torch.zeros(
            (image_size // patch_size) ** 2 + 1, width, device=device))
        self.ln_pre = LayerNormF32(width, device=device)
        self.transformer = Container(resblocks=nn.ModuleList(
            CLIPResBlock(width, heads, device) for _ in range(layers)))
        self.ln_post = LayerNormF32(width, device=device)
        self.proj = nn.Parameter(torch.zeros(width, embed_dim, device=device))

    def forward(self, images):
        B = images.shape[0]
        x = self.conv1(images).reshape(B, -1, self.width)
        cls = self.class_embedding.float().expand(B, 1, self.width)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding.float())
        for blk in self.transformer.resblocks:
            x = blk(x)
        return self.ln_post(x[:, 0]) @ self.proj.float()
