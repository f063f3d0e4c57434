"""Host data pipeline: the CSV image/caption dataset with CFG drop
augmentation, a copy of ``kandinsky2_tpu/train/data.py`` (numpy and PIL
only; the JAX package's module imports its JAX pipeline).

Reference: kandinsky2/train_utils/data/dataset_unclip_2_1.py (decoder:
image in [-1, 1], XLM-R tokens/mask, CLIP image, independent text/image
drop) and dataset_prior.py (prior: CLIP image, BPE tokens/mask).  The
loader is a thread-prefetched numpy batch iterator, with the same
``RandomState`` draws (drops, shuffles) as the JAX package's, so both see
the same batches.
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from typing import Iterator

import numpy as np

from ..pipelines.kandinsky2_1 import clip_preprocess


def _load_image(path, size):
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    return img.crop((left, top, left + size, top + size))


class TextImageDataset:
    """CSV(image_name, caption) -> per-sample dicts
    (dataset_unclip_2_1.py:58-123).  ``mode`` "decoder" gives the image and
    the tokenizer's HF-style ids and mask; "prior" gives BPE tokens and a
    bool mask from ``tokenizer.padded_tokens_and_mask``."""

    def __init__(
        self,
        csv_path: str,
        image_dir: str = "",
        tokenizer=None,
        clip_image_size: int = 224,
        image_size: int = 512,
        drop_text_prob: float = 0.5,
        drop_image_prob: float = 0.1,
        seq_len: int = 77,
        seed: int = 0,
        mode: str = "decoder",
    ):
        if mode not in ("decoder", "prior"):
            raise ValueError(f"unknown mode {mode!r}")
        with open(csv_path) as f:
            rows = list(csv.DictReader(f))
        self.names = [r["image_name"] for r in rows]
        self.captions = [r["caption"] for r in rows]
        self.image_dir = image_dir
        self.tokenizer = tokenizer
        self.clip_image_size = clip_image_size
        self.image_size = image_size
        self.drop_text_prob = drop_text_prob
        self.drop_image_prob = drop_image_prob
        self.seq_len = seq_len
        self.rng = np.random.RandomState(seed)
        self.mode = mode

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx: int) -> dict:
        from PIL import Image

        path = os.path.join(self.image_dir, self.names[idx])
        caption = self.captions[idx]
        if self.rng.rand() < self.drop_text_prob:
            caption = ""
        pil = _load_image(path, max(self.image_size, self.clip_image_size))
        clip_image = clip_preprocess(
            pil.resize((self.clip_image_size, self.clip_image_size), Image.BICUBIC),
            self.clip_image_size,
        )[0]
        if self.rng.rand() < self.drop_image_prob:
            clip_image = np.zeros_like(clip_image)
        out = {"clip_image": clip_image.astype(np.float32)}
        if self.mode == "prior":
            toks, mask = self.tokenizer.padded_tokens_and_mask([caption], self.seq_len)
            out["tokens"] = toks[0].astype(np.int32)
            out["mask"] = mask[0]
            return out
        img = pil.resize((self.image_size, self.image_size), Image.BICUBIC)
        enc = self.tokenizer(
            caption, max_length=self.seq_len, padding="max_length",
            truncation=True, return_attention_mask=True,
            add_special_tokens=True, return_tensors="np",
        )
        out["image"] = np.asarray(img, np.float32) / 127.5 - 1
        out["tokens"] = enc["input_ids"][0].astype(np.int32)
        out["mask"] = enc["attention_mask"][0].astype(np.int32)
        return out


class _Loader:
    """Re-iterable batched loader with background-thread prefetch (replaces
    the torch DataLoader of dataset_unclip_2_1.py:125-134).  Each ``__iter__``
    is a fresh epoch (reshuffled), so multi-epoch ``for raw in loader`` loops
    behave like a DataLoader."""

    def __init__(self, dataset, batch_size, shuffle, drop_last, prefetch, seed):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        for i in range(0, len(order), bs):
            idxs = order[i : i + bs]
            if len(idxs) < bs and self.drop_last:
                break
            samples = [self.dataset[int(j)] for j in idxs]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        DONE = object()

        def worker():
            for b in self._batches():
                q.put(b)
            q.put(DONE)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is DONE:
                break
            yield item

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n


def create_loader(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    drop_last: bool = True,
    prefetch: int = 2,
    seed: int = 0,
) -> _Loader:
    return _Loader(dataset, batch_size, shuffle, drop_last, prefetch, seed)
