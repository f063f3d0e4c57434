"""CLIP byte-pair-encoding tokenizer (host-side, pure Python), a copy of
``kandinsky2_tpu/tokenizers/clip_bpe.py``; the ``regex`` module is imported
at first use, so the package imports where it is not installed.

Independent implementation of the standard CLIP BPE scheme used by the
reference's ``CustomizedTokenizer`` (kandinsky2/model/prior.py:387-416, which
subclasses openai-clip's SimpleTokenizer).  The merges table
(``bpe_simple_vocab_16e6.txt.gz``) ships with the checkpoints; pass its path.

Differences from openai-clip: if ``ftfy`` is unavailable we fall back to
``tokenizers.textfix.fix_text`` — a stdlib reimplementation of ftfy's
mojibake repair + NFC normalization — so mojibake prompts still tokenize
like the reference.
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache
from typing import List, Tuple

import numpy as np

_TOKEN_PATTERN = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
)


@lru_cache()
def _regex():
    """(the ``regex`` module, the compiled token pattern)."""
    import regex

    return regex, regex.compile(_TOKEN_PATTERN, regex.IGNORECASE)


@lru_cache()
def _bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (GPT-2/CLIP convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


def _clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        from .textfix import fix_text

        text = fix_text(text)
    text = html.unescape(html.unescape(text))
    return _regex()[0].sub(r"\s+", " ", text.strip()).lower()


class CLIPBPETokenizer:
    """CLIP BPE with the reference's padding contract."""

    def __init__(self, bpe_path: str, vocab_path: str | None = None):
        if bpe_path.endswith(".gz"):
            merges_txt = gzip.open(bpe_path, "rt", encoding="utf-8").read()
        else:
            merges_txt = open(bpe_path, encoding="utf-8").read()
        merges = merges_txt.split("\n")[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m.strip()]
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if vocab_path is not None:
            # HF CLIPTokenizer snapshot (vocab.json): authoritative token→id
            # map; merges still drive the BPE joins
            import json

            with open(vocab_path, encoding="utf-8") as f:
                self.encoder = json.load(f)
        else:
            vocab = list(self.byte_encoder.values())
            vocab = vocab + [v + "</w>" for v in vocab]
            vocab += ["".join(m) for m in merges]
            vocab += ["<|startoftext|>", "<|endoftext|>"]
            self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self._cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        re, token_re = _regex()
        for token in re.findall(token_re, _clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self._bpe(token).split(" ")
            )
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        data = bytearray(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")

    @classmethod
    def from_hf_dir(cls, tokenizer_dir: str) -> "CLIPBPETokenizer":
        """Build from an HF CLIPTokenizer snapshot dir (the 2.2 prior repo's
        ``tokenizer/`` subfolder: merges.txt + vocab.json)."""
        import os

        merges = os.path.join(tokenizer_dir, "merges.txt")
        vocab = os.path.join(tokenizer_dir, "vocab.json")
        return cls(merges, vocab_path=vocab if os.path.exists(vocab) else None)

    def padded_tokens_and_mask(self, texts, text_ctx: int):
        """sot + bpe + eot, truncated so eot survives; bool mask
        (prior.py:394-416)."""
        all_tokens = [
            [self.sot_token] + self.encode(t) + [self.eot_token] for t in texts
        ]
        mask = np.zeros((len(all_tokens), text_ctx), dtype=bool)
        result = np.zeros((len(all_tokens), text_ctx), dtype=np.int32)
        for i, tokens in enumerate(all_tokens):
            mask[i, : min(text_ctx, len(tokens))] = True
            if len(tokens) > text_ctx:
                tokens = tokens[:text_ctx]
                tokens[-1] = self.eot_token
            result[i, : len(tokens)] = np.asarray(tokens, dtype=np.int32)
        return result, mask
