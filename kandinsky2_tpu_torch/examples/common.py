"""Shared helpers of the example scripts: the flags, the pipelines (small
random-weight ones for ``--small``, else the published checkpoints from a
local cache) and a seeded test image."""

from __future__ import annotations

import argparse

import numpy as np


def argparser(**extra) -> argparse.ArgumentParser:
    """The flags every example takes, plus ``extra`` ({flag: default})."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="small random-weight config (no checkpoints needed)")
    ap.add_argument("--prompt", default="red cat, 4k photo")
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--cache-dir", default="/tmp/kandinsky2",
                    help="the local checkpoint cache read without --small")
    for k, v in extra.items():
        ap.add_argument(f"--{k}", default=v)
    return ap


def _pipe(args, version: str, task_type: str, param_dtype=None):
    if args.small:
        from ..serving_http import build_small_pipeline

        return build_small_pipeline(version, device=args.device, task_type=task_type,
                                    param_dtype=param_dtype)
    from .. import get_kandinsky2

    return get_kandinsky2(args.device, task_type=task_type, cache_dir=args.cache_dir,
                          model_version=version)


def make_pipe21(args, task_type: str = "text2img", param_dtype=None):
    """(pipeline, generation kwargs) of 2.1: with ``--small``
    ``configs.small_config`` at 64², 4 decoder and 3 prior steps; else the
    cached checkpoints (their XLM-R tokenizer is a sentencepiece file the
    port cannot read, so the cache alone raises, naming it) at 768²,
    100 steps, prior "5"."""
    pipe = _pipe(args, "2.1", task_type, param_dtype)
    if args.small:
        return pipe, dict(num_steps=4, h=64, w=64, prior_steps="3")
    return pipe, dict(num_steps=100, h=768, w=768, prior_steps="5")


def make_pipe20(args, task_type: str = "text2img", param_dtype=None):
    """(pipeline, generation kwargs) of 2.0: ``configs.small_config20`` at
    64² and 4 steps, or the cached checkpoints (which need the XLM-R and
    mT5 sentencepiece tokenizers: the cache alone raises) at 512², 100
    steps."""
    pipe = _pipe(args, "2.0", task_type, param_dtype)
    if args.small:
        return pipe, dict(num_steps=4, h=64, w=64)
    return pipe, dict(num_steps=100, h=512, w=512)


def make_pipe22(args, task_type: str = "text2img", param_dtype=None):
    """(pipeline, generation kwargs) of 2.2: ``configs.small_overrides22``
    at 64², 4 decoder and 3 prior steps, or the cached diffusers snapshots
    at 768², 50 and 25."""
    pipe = _pipe(args, "2.2", task_type, param_dtype)
    if args.small:
        return pipe, dict(decoder_steps=4, prior_steps=3, h=64, w=64)
    return pipe, dict(decoder_steps=50, prior_steps=25, h=768, w=768)


def random_image(size: int = 64, seed: int = 0):
    """A seeded RGB noise image, ``size``²."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    return Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8))
