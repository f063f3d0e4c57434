"""Host-side helpers of the 2.1 text2img path, copied from
``kandinsky2_tpu/utils.py`` (which imports the JAX diffusion package)."""

from __future__ import annotations

import numpy as np
import torch


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
    arr = torch.as_tensor(np.asarray(noise, np.float32), device=device)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(arr.shape)}, expected {tuple(shape)}"
        )
    return arr


def images_to_uint8(batch: np.ndarray) -> np.ndarray:
    """[-1, 1] float NHWC -> uint8 (utils.py:57-66): round half to even,
    then clamp to [0, 255]."""
    arr = np.asarray(batch, np.float32)
    return np.clip(np.rint((arr + 1.0) * 127.5), 0, 255).astype(np.uint8)


def stub_tokenizers():
    """Deterministic stand-ins for the XLM-R (HF call) and CLIP BPE
    tokenizers, for runs with random weights; the same as ``bench.py``'s."""

    class HFTok:
        def __call__(self, texts, max_length=77, **kw):
            n = len(texts)
            ids = np.ones((n, max_length), np.int32)
            mask = np.zeros((n, max_length), np.int32)
            for i, t in enumerate(texts):
                L = min(max_length, 2 + len(t.split()))
                ids[i, :L] = 5 + (np.arange(L) % 1000)
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


def process_images(batch: np.ndarray):
    """[-1, 1] float NHWC -> list of PIL images."""
    from PIL import Image

    scaled = images_to_uint8(batch)
    return [Image.fromarray(scaled[i]) for i in range(scaled.shape[0])]
