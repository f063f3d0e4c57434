"""Text and image encoder towers, the counterpart of
``kandinsky2_tpu/models/text_encoders.py``: XLM-RoBERTa + MultilingualCLIP
and ``BertEncoder`` behind the ``TextEncoder`` facade (with the OpenAI CLIP
text tower and ``models/t5.py``'s T5), the OpenAI CLIP text tower and ViT of
2.1, and the HF-layout CLIP vision tower with projection of 2.2
(``HFCLIPVision``, ViT-bigG-14).  Their attention is masked or short, so it
stays plain PyTorch with the JAX package's semantics (fp32 logits and
softmax).
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


def exact_gelu(x):
    return F.gelu(x)


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


class BertEncoder(nn.Module):
    """HF ``BertModel`` layout: absolute position embeddings from 0, token
    type 0, the XLM-R encoder stack, and the tanh pooler over [CLS]
    (reference text_encoders.py:134-137, 156-158).  Returns (full,
    pooled)."""

    def __init__(self, vocab_size=30522, hidden=768, layers=12, heads=12,
                 intermediate=3072, max_positions=512, type_vocab=2, eps=1e-12,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
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
        self.pooler = Container(dense=Linear(hidden, hidden, dtype=dtype, device=device))

    def forward(self, input_ids, attention_mask):
        e = self.embeddings
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = (e.word_embeddings(input_ids) + e.position_embeddings(pos)[None]
               + e.token_type_embeddings(torch.zeros_like(input_ids)))
        h = e.LayerNorm(emb).to(self.dtype)
        attn_mask = (1.0 - attention_mask.float())[:, None, None, :] * NEG_INF
        for layer in self.encoder.layer:
            h = layer(h, attn_mask)
        return h, torch.tanh(self.pooler.dense(h[:, 0]))


class TextEncoder(nn.Module):
    """Facade over the text-encoder backends (text_encoders.py:125-167):
    'multiclip' (XLM-R + MultilingualCLIP, 2.0's and 2.1's), 'clip' (the
    OpenAI CLIP text tower), 'T5EncoderModel' / 'MT5EncoderModel'
    (``models/t5.py``), 'BertModel' and 'xlm_roberta'.  Each returns the
    reference's (full, pooled), pooled None where the backend has no
    pooling.  ``in_features`` is the tower width, ``out_features`` the
    projection width, ``max_positions`` the context length for 'clip'."""

    def __init__(self, model_name="multiclip", in_features=1024, out_features=768,
                 layers=24, heads=16, intermediate=4096, vocab_size=250002,
                 max_positions=514, dtype=torch.float32, device=None):
        super().__init__()
        self.model_name = model_name
        self.max_positions = max_positions
        kw = dict(dtype=dtype, device=device)
        if model_name == "multiclip":
            self.model = MultilingualCLIP(
                out_features=out_features, vocab_size=vocab_size, hidden=in_features,
                layers=layers, heads=heads, intermediate=intermediate,
                max_positions=max_positions, **kw)
        elif model_name == "clip":
            self.model = CLIPTextTower(
                vocab_size=vocab_size, context_length=max_positions, width=in_features,
                layers=layers, heads=heads, embed_dim=out_features, **kw)
        elif model_name in ("T5EncoderModel", "MT5EncoderModel"):
            from .t5 import T5Encoder

            self.model = T5Encoder(
                vocab_size=vocab_size, d_model=in_features, d_kv=in_features // heads,
                d_ff=intermediate, num_layers=layers, num_heads=heads, **kw)
        elif model_name == "BertModel":
            self.model = BertEncoder(
                vocab_size=vocab_size, hidden=in_features, layers=layers, heads=heads,
                intermediate=intermediate, max_positions=max_positions, **kw)
        elif model_name == "xlm_roberta":
            self.model = XLMRobertaEncoder(
                vocab_size=vocab_size, hidden=in_features, layers=layers, heads=heads,
                intermediate=intermediate, max_positions=max_positions, **kw)
        else:
            raise NotImplementedError(model_name)

    def forward(self, tokens, mask=None):
        name = self.model_name
        if name == "multiclip":
            pooled, full = self.model(tokens, mask)
            return full, pooled
        if name == "clip":
            return self.model(tokens)
        if name == "BertModel":
            return self.model(tokens, mask)
        full = self.model(tokens, mask)
        return (full.float() if name == "xlm_roberta" else full), None


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


class _HFCLIPLayer(nn.Module):
    """HF CLIPEncoderLayer: pre-LN, separate q/k/v projections, an MLP with
    ``act`` (exact GELU for ViT-bigG)."""

    def __init__(self, hidden, heads, intermediate, act=exact_gelu, eps=1e-5,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads, self.act = heads, act
        self.layer_norm1 = LayerNormF32(hidden, eps, device=device)
        self.self_attn = Container(
            q_proj=Linear(hidden, hidden, **kw), k_proj=Linear(hidden, hidden, **kw),
            v_proj=Linear(hidden, hidden, **kw), out_proj=Linear(hidden, hidden, **kw))
        self.layer_norm2 = LayerNormF32(hidden, eps, device=device)
        self.mlp = Container(fc1=Linear(hidden, intermediate, **kw),
                             fc2=Linear(intermediate, hidden, **kw))

    def forward(self, x, mask=None):
        h = self.layer_norm1(x)
        at = self.self_attn
        a = _mha(at.q_proj(h), at.k_proj(h), at.v_proj(h), self.heads, mask)
        x = x + at.out_proj(a)
        return x + self.mlp.fc2(self.act(self.mlp.fc1(self.layer_norm2(x))))


class HFCLIPVision(nn.Module):
    """HF ``CLIPVisionModelWithProjection`` layout (the 2.2 image encoder);
    the defaults are ViT-bigG-14 with projection_dim 1280.  NHWC images
    already CLIP-normalised -> the projected embedding [B, projection_dim]
    in fp32."""

    def __init__(self, image_size=224, patch_size=14, hidden=1664, layers=48,
                 heads=16, intermediate=8192, projection_dim=1280, act=exact_gelu,
                 eps=1e-5, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.hidden = hidden
        self.image_size = image_size
        n_pos = (image_size // patch_size) ** 2 + 1
        embeddings = Container(
            patch_embedding=Conv2d(3, hidden, patch_size, stride=patch_size, padding=0,
                                   bias=False, dtype=dtype, device=device),
            position_embedding=nn.Embedding(n_pos, hidden, device=device))
        embeddings.class_embedding = nn.Parameter(torch.zeros(hidden, device=device))
        self.vision_model = Container(
            embeddings=embeddings,
            pre_layrnorm=LayerNormF32(hidden, eps, device=device),
            encoder=Container(layers=nn.ModuleList(
                _HFCLIPLayer(hidden, heads, intermediate, act, eps, dtype, device)
                for _ in range(layers))),
            post_layernorm=LayerNormF32(hidden, eps, device=device))
        self.visual_projection = Linear(hidden, projection_dim, bias=False,
                                        device=device)

    def forward(self, images):
        vm = self.vision_model
        B = images.shape[0]
        x = vm.embeddings.patch_embedding(images.to(self.dtype)).reshape(B, -1, self.hidden)
        cls = vm.embeddings.class_embedding.to(x.dtype).expand(B, 1, self.hidden)
        x = torch.cat([cls, x], dim=1)
        x = x + vm.embeddings.position_embedding.weight.to(x.dtype)[None]
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        pooled = vm.post_layernorm(x[:, 0])
        return self.visual_projection(pooled.float())
