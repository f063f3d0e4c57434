"""The deterministic stand-in tokenizers that runs with random weights use
(the published sentencepiece and BPE files are not in the repository):
CLIP BPE for the 2.2 prior and XLM-R for the 2.1 decoder."""

from __future__ import annotations

import numpy as np


def clip_tokens(texts, ctx: int, vocab_size: int, eot: int):
    """(ids [n, ctx], keep mask): min(ctx, 2 + len(text)) positions, the
    last the end-of-text id, the others 1, 2, ... below vocab_size - 4."""
    n = len(texts)
    toks, mask = np.zeros((n, ctx), np.int64), np.zeros((n, ctx), bool)
    id_range = min(49000, vocab_size - 4)
    for i, t in enumerate(texts):
        L = min(ctx, 2 + len(t))
        toks[i, :L - 1] = 1 + (np.arange(L - 1) % id_range)
        toks[i, L - 1] = eot
        mask[i, :L] = True
    return toks, mask


def xlmr_tokens(texts, max_length: int, vocab_size: int):
    """(ids [n, max_length] padded with 1, mask): 2 + words positions."""
    n = len(texts)
    ids, mask = np.ones((n, max_length), np.int64), np.zeros((n, max_length), np.int64)
    id_range = min(1000, vocab_size - 5)
    for i, t in enumerate(texts):
        L = min(max_length, 2 + len(t.split()))
        ids[i, :L] = 5 + (np.arange(L) % id_range)
        mask[i, :L] = 1
    return ids, mask
