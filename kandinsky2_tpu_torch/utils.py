"""Host-side helpers of 2.1 and 2.2 inference, copied from
``kandinsky2_tpu/utils.py`` (which imports the JAX diffusion package):
prompts, injected noise, the init image and mask of img2img and
inpainting, the stand-in tokenizers of runs with random weights, and the
conversion of the images to PIL."""

from __future__ import annotations

import numpy as np
import torch

from .host_ops import erode_mask, f32_to_u8_images


def prepare_image(pil_image, w: int = 512, h: int = 512) -> np.ndarray:
    """PIL -> [1, H, W, 3] float32 in [-1, 1] (utils.py:33-39), NHWC."""
    from PIL import Image

    pil_image = pil_image.resize((w, h), resample=Image.BICUBIC, reducing_gap=1)
    arr = np.array(pil_image.convert("RGB")).astype(np.float32) / 127.5 - 1
    return arr[None]


def prepare_image_batch(images, w: int, h: int, batch_size: int) -> np.ndarray:
    """One init image, or a list of ``batch_size`` (one a batch row), ->
    [1 or B, H, W, 3]; a single image keeps batch 1 for the caller to tile
    after noising."""
    if isinstance(images, (list, tuple)):
        if len(images) != batch_size:
            raise ValueError(f"got {len(images)} init images for batch {batch_size}")
        return np.concatenate([prepare_image(im, w=w, h=h) for im in images])
    return prepare_image(images, w=w, h=h)


def prepare_mask(mask: np.ndarray) -> np.ndarray:
    """Erode the keep region of a [1, H, W, 1] or [H, W] mask (1 = keep,
    0 = inpaint) by one latent pixel (utils.py:11-30), shape kept."""
    m = np.asarray(mask, dtype=np.float32)
    if m.ndim == 4:
        hw = m[0, :, :, 0]
    elif m.ndim == 2:
        hw = m
    else:
        raise ValueError(f"mask shape {m.shape}")
    return erode_mask(hw).reshape(m.shape)


def get_new_h_w(h: int, w: int) -> tuple[int, int]:
    """Pixel dims -> latent dims, 64-px aligned (kandinsky2_1_model.py:106-113):
    latent cell = 8 * ceil(dim/64)."""
    return ((h + 63) // 64) * 8, ((w + 63) // 64) * 8


def as_prompt_list(prompt, batch_size: int) -> list[str]:
    """A prompt argument as a per-sample list of length B: one string
    repeated, a one-element list broadcast, or exactly B prompts."""
    if isinstance(prompt, str):
        return [prompt] * batch_size
    prompts = [str(p) for p in prompt]
    if len(prompts) == 1 and batch_size > 1:
        return prompts * batch_size
    if len(prompts) != batch_size:
        raise ValueError(
            f"got {len(prompts)} prompts for batch_size={batch_size}; pass "
            "one prompt, or exactly batch_size prompts"
        )
    return prompts


def resolve_batch(prompt, batch_size: int) -> int:
    """Infer batch size from a prompt list when the caller left it at 1."""
    if not isinstance(prompt, str) and batch_size == 1:
        return max(len(list(prompt)), 1)
    return batch_size


def check_noise(noise, shape, name: str = "noise", device=None):
    """User-injected noise as a float32 tensor on ``device``, after checking
    it has the shape the trajectory would have drawn; None passes through."""
    if noise is None:
        return None
    if isinstance(noise, torch.Tensor):
        arr = noise.to(device=device, dtype=torch.float32)
    else:
        arr = torch.as_tensor(np.asarray(noise, np.float32), device=device)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(arr.shape)}, expected {tuple(shape)}"
        )
    return arr


def stub_tokenizers(vocab_size: int = 250002):
    """Deterministic stand-ins for the XLM-R (HF call) and CLIP BPE
    tokenizers, for runs with random weights; the same as ``bench.py``'s.
    The XLM-R stand-in keeps its ids below ``vocab_size``."""
    id_range = min(1000, vocab_size - 5)

    class HFTok:
        def __call__(self, texts, max_length=77, **kw):
            if isinstance(texts, str):
                texts = [texts]
            n = len(texts)
            ids = np.ones((n, max_length), np.int32)
            mask = np.zeros((n, max_length), np.int32)
            for i, t in enumerate(texts):
                L = min(max_length, 2 + len(t.split()))
                ids[i, :L] = 5 + (np.arange(L) % id_range)
                mask[i, :L] = 1
            return {"input_ids": ids, "attention_mask": mask}

    class BPETok:
        def padded_tokens_and_mask(self, texts, ctx):
            n = len(texts)
            toks = np.zeros((n, ctx), np.int32)
            mask = np.zeros((n, ctx), bool)
            for i, t in enumerate(texts):
                L = min(ctx, 2 + len(t))
                toks[i, :L] = 1 + (np.arange(L) % 49000)
                mask[i, :L] = True
            return toks, mask

    return HFTok(), BPETok()


def stub_tokenizer22(vocab_size: int = 49408, eot_token_id: int | None = None):
    """A deterministic stand-in for the 2.2 prior's CLIP BPE tokenizer, for
    runs with random weights: each prompt's ids end with the end-of-text id
    (``vocab_size - 1`` by default, 49407 for CLIP), where ``HFCLIPText``
    pools; the other ids stay below ``vocab_size - 4``.  The same as
    ``tests/test_pipeline22.py``'s at its tiny vocabulary."""
    eot = vocab_size - 1 if eot_token_id is None else eot_token_id
    id_range = min(49000, vocab_size - 4)

    class BPETok:
        def padded_tokens_and_mask(self, texts, ctx):
            n = len(texts)
            toks = np.zeros((n, ctx), np.int32)
            mask = np.zeros((n, ctx), bool)
            for i, t in enumerate(texts):
                L = min(ctx, 2 + len(t))
                toks[i, :L - 1] = 1 + (np.arange(L - 1) % id_range)
                toks[i, L - 1] = eot
                mask[i, :L] = True
            return toks, mask

    return BPETok()


def process_images(batch: np.ndarray):
    """[-1, 1] float NHWC -> list of PIL images."""
    from PIL import Image

    scaled = f32_to_u8_images(batch)
    return [Image.fromarray(scaled[i]) for i in range(scaled.shape[0])]
