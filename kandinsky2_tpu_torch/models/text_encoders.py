"""Text and image encoder towers of the 2.1 path, the counterpart of
``kandinsky2_tpu/models/text_encoders.py``: XLM-RoBERTa + MultilingualCLIP
behind ``TextEncoder`` ('multiclip'), and the OpenAI CLIP text tower and
ViT.  Their attention is masked or short, so it stays plain PyTorch with the
JAX package's semantics (fp32 logits and softmax).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Container, Conv2d, LayerNormF32, Linear

NEG_INF = torch.finfo(torch.float32).min


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _mha(q, k, v, heads, mask=None):
    """Multi-head attention with fp32 logits and softmax.  q/k/v [B, T, W];
    mask additive [T, S] or [B, 1, T, S]."""
    B, T, W = q.shape
    ch = W // heads
    q = q.reshape(B, T, heads, ch)
    k = k.reshape(B, k.shape[1], heads, ch)
    v = v.reshape(B, v.shape[1], heads, ch)
    logits = torch.einsum("bthc,bshc->bhts", q.float(), k.float()) / math.sqrt(ch)
    if mask is not None:
        logits = logits + mask.float()
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshc->bthc", w, v).reshape(B, T, W)


class _BertLayer(nn.Module):
    """Post-LN BERT/RoBERTa encoder layer (HF naming)."""

    def __init__(self, hidden, heads, intermediate, eps=1e-5,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.attention = Container(
            self=Container(
                query=Linear(hidden, hidden, **kw),
                key=Linear(hidden, hidden, **kw),
                value=Linear(hidden, hidden, **kw),
            ),
            output=Container(
                dense=Linear(hidden, hidden, **kw),
                LayerNorm=LayerNormF32(hidden, eps, device=device),
            ),
        )
        self.intermediate = Container(dense=Linear(hidden, intermediate, **kw))
        self.output = Container(
            dense=Linear(intermediate, hidden, **kw),
            LayerNorm=LayerNormF32(hidden, eps, device=device),
        )

    def forward(self, x, attn_mask):
        att = self.attention
        a = _mha(att.self.query(x), att.self.key(x), att.self.value(x),
                 self.heads, attn_mask)
        x = att.output.LayerNorm(x + att.output.dense(a))
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class XLMRobertaEncoder(nn.Module):
    """XLM-RoBERTa encoder returning last_hidden_state; padding-aware
    position ids cumsum(mask)·mask + padding_idx."""

    def __init__(self, vocab_size=250002, hidden=1024, layers=24, heads=16,
                 intermediate=4096, max_positions=514, type_vocab=1,
                 pad_token_id=1, eps=1e-5, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.pad_token_id = pad_token_id
        self.embeddings = Container(
            word_embeddings=nn.Embedding(vocab_size, hidden, device=device),
            position_embeddings=nn.Embedding(max_positions, hidden, device=device),
            token_type_embeddings=nn.Embedding(type_vocab, hidden, device=device),
            LayerNorm=LayerNormF32(hidden, eps, device=device),
        )
        self.encoder = Container(layer=nn.ModuleList(
            _BertLayer(hidden, heads, intermediate, eps, dtype, device)
            for _ in range(layers)
        ))

    def forward(self, input_ids, attention_mask):
        mask = attention_mask.long()
        pos_ids = torch.cumsum(mask, dim=1) * mask + self.pad_token_id
        e = self.embeddings
        emb = (e.word_embeddings(input_ids) + e.position_embeddings(pos_ids)
               + e.token_type_embeddings(torch.zeros_like(input_ids)))
        h = e.LayerNorm(emb).to(self.dtype)
        attn_mask = (1.0 - attention_mask.float())[:, None, None, :] * NEG_INF
        for layer in self.encoder.layer:
            h = layer(h, attn_mask)
        return h


class MultilingualCLIP(nn.Module):
    """XLM-R + masked-mean pooling + Linear head (text_encoders.py:108-122).
    Returns (pooled_projected, full_emb)."""

    def __init__(self, out_features=768, vocab_size=250002, hidden=1024,
                 layers=24, heads=16, intermediate=4096, max_positions=514,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.transformer = XLMRobertaEncoder(
            vocab_size=vocab_size, hidden=hidden, layers=layers, heads=heads,
            intermediate=intermediate, max_positions=max_positions,
            dtype=dtype, device=device,
        )
        self.LinearTransformation = Linear(hidden, out_features, dtype=dtype,
                                           device=device)

    def forward(self, input_ids, attention_mask):
        embs = self.transformer(input_ids, attention_mask)
        m = attention_mask.to(embs.dtype)[:, :, None]
        pooled = (embs * m).sum(dim=1) / m.sum(dim=1)
        return self.LinearTransformation(pooled), embs


class TextEncoder(nn.Module):
    """Facade over the text-encoder backends (text_encoders.py:125-167); the
    port has 'multiclip', the 2.1 one.  Returns (full, pooled)."""

    def __init__(self, model_name="multiclip", in_features=1024, out_features=768,
                 layers=24, heads=16, intermediate=4096, vocab_size=250002,
                 max_positions=514, dtype=torch.float32, device=None):
        super().__init__()
        if model_name != "multiclip":
            raise NotImplementedError(f"text encoder {model_name} is not ported")
        self.max_positions = max_positions
        self.model = MultilingualCLIP(
            out_features=out_features, vocab_size=vocab_size, hidden=in_features,
            layers=layers, heads=heads, intermediate=intermediate,
            max_positions=max_positions, dtype=dtype, device=device,
        )

    def forward(self, tokens, mask):
        pooled, full = self.model(tokens, mask)
        return full, pooled


class CLIPResBlock(nn.Module):
    """OpenAI CLIP ResidualAttentionBlock: pre-LN, fused in_proj ([q;k;v]
    chunks of width), QuickGELU MLP."""

    def __init__(self, width, heads, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.ln_1 = LayerNormF32(width, device=device)
        self.attn = Container(
            in_proj=Linear(width, 3 * width, **kw),
            out_proj=Linear(width, width, **kw),
        )
        self.ln_2 = LayerNormF32(width, device=device)
        self.mlp = Container(
            c_fc=Linear(width, 4 * width, **kw),
            c_proj=Linear(4 * width, width, **kw),
        )

    def forward(self, x, mask=None):
        q, k, v = self.attn.in_proj(self.ln_1(x)).chunk(3, dim=-1)
        x = x + self.attn.out_proj(_mha(q, k, v, self.heads, mask))
        h = quick_gelu(self.mlp.c_fc(self.ln_2(x)))
        return x + self.mlp.c_proj(h)


class CLIPTextTower(nn.Module):
    """OpenAI CLIP text transformer with EOT pooling and projection
    (kandinsky2_1_model.py:159-167).  Returns (txt_feat_seq, txt_feat)."""

    def __init__(self, vocab_size=49408, context_length=77, width=768,
                 layers=12, heads=12, embed_dim=768, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.context_length = context_length
        self.token_embedding = nn.Embedding(vocab_size, width, device=device)
        self.positional_embedding = nn.Parameter(
            torch.zeros(context_length, width, device=device))
        self.transformer = Container(resblocks=nn.ModuleList(
            CLIPResBlock(width, heads, dtype, device) for _ in range(layers)
        ))
        self.ln_final = LayerNormF32(width, device=device)
        self.text_projection = nn.Parameter(
            torch.zeros(width, embed_dim, device=device))

    def forward(self, tokens):
        x = self.token_embedding(tokens).to(self.dtype)
        x = x + self.positional_embedding.to(self.dtype)
        L = self.context_length
        causal = torch.triu(
            torch.full((L, L), NEG_INF, device=x.device), diagonal=1
        )
        for blk in self.transformer.resblocks:
            x = blk(x, causal)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot].float()
        return x.float(), pooled @ self.text_projection.float()


class CLIPViT(nn.Module):
    """OpenAI CLIP vision tower (``encode_image``), NHWC input already
    CLIP-normalised."""

    def __init__(self, image_size=224, patch_size=14, width=1024, layers=24,
                 heads=16, embed_dim=768, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.width = width
        self.conv1 = Conv2d(3, width, patch_size, stride=patch_size, padding=0,
                            bias=False, dtype=dtype, device=device)
        self.class_embedding = nn.Parameter(torch.zeros(width, device=device))
        self.positional_embedding = nn.Parameter(torch.zeros(
            (image_size // patch_size) ** 2 + 1, width, device=device))
        self.ln_pre = LayerNormF32(width, device=device)
        self.transformer = Container(resblocks=nn.ModuleList(
            CLIPResBlock(width, heads, dtype, device) for _ in range(layers)
        ))
        self.ln_post = LayerNormF32(width, device=device)
        self.proj = nn.Parameter(torch.zeros(width, embed_dim, device=device))

    def forward(self, images):
        B = images.shape[0]
        x = self.conv1(images.to(self.dtype)).reshape(B, -1, self.width)
        cls = self.class_embedding.to(x.dtype).expand(B, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)
        for blk in self.transformer.resblocks:
            x = blk(x)
        x = self.ln_post(x[:, 0])
        return x.float() @ self.proj.float()
