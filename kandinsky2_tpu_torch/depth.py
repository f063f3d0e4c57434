"""Host-side depth hints for the 2.2 ControlNet-depth decoder, the
counterpart of ``kandinsky2_tpu/depth.py``:

* :func:`make_hint` — any depth map -> the float32 [H, W, 3] hint in
  [0, 1] (channels replicated), resized to the target;
* :func:`dpt_estimator` — the trained estimator: a ``models.dpt.DPTDepth``
  loaded from a local HF DPT snapshot (``weights.hub.fetch_dpt``), on the
  card; the image is preprocessed on the host (PIL bicubic resize to the
  model's square size, (x/255 - 0.5)/0.5);
* :func:`heuristic_depth` — the documented, deterministic NON-PARITY
  estimator from monocular cues (ground-plane vertical prior, local
  sharpness, luma).  It is not MiDaS and makes no quality claim against it;
* :func:`default_estimator` — the DPT when ``repo_dir`` or
  ``$KANDINSKY2_DPT_DIR`` holds a snapshot, else the heuristic.

Apart from the DPT forward, everything here is numpy on the host; the
pipeline sees only the finished hint.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np

__all__ = ["heuristic_depth", "make_hint", "dpt_estimator", "default_estimator"]


def _box_blur(x: np.ndarray, radius: int) -> np.ndarray:
    """Separable box blur with edge replication."""
    if radius <= 0:
        return x
    k = 2 * radius + 1
    pad = np.pad(x, ((radius, radius), (0, 0)), mode="edge")
    csum = np.cumsum(pad, axis=0)
    csum = np.concatenate([np.zeros((1,) + csum.shape[1:]), csum], axis=0)
    x = (csum[k:] - csum[:-k]) / k
    pad = np.pad(x, ((0, 0), (radius, radius)), mode="edge")
    csum = np.cumsum(pad, axis=1)
    csum = np.concatenate([np.zeros((csum.shape[0], 1)), csum], axis=1)
    return (csum[:, k:] - csum[:, :-k]) / k


def _normalize01(x: np.ndarray) -> np.ndarray:
    lo, hi = float(x.min()), float(x.max())
    if hi - lo < 1e-8:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def heuristic_depth(image) -> np.ndarray:
    """Deterministic monocular-cue depth estimate, [H, W] float32 in [0, 1]
    (1 = near, MiDaS' inverse-depth convention): 0.6 ground-plane prior
    (lower rows nearer), 0.25 local sharpness, 0.15 darkness, each
    smoothed.  NON-PARITY: it drives the ControlNet path offline."""
    arr = np.asarray(image, np.float32)
    if arr.ndim == 3:
        luma = 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
    else:
        luma = arr
    if luma.max() > 1.5:  # uint8-range input
        luma = luma / 255.0
    H, W = luma.shape
    r = max(1, min(H, W) // 64)
    vertical = np.broadcast_to(np.linspace(0.0, 1.0, H, dtype=np.float32)[:, None],
                               (H, W))
    highfreq = np.abs(luma - _box_blur(luma, r))
    sharpness = _normalize01(_box_blur(highfreq, 4 * r))
    darkness = _normalize01(_box_blur(1.0 - luma, 2 * r))
    depth = 0.6 * vertical + 0.25 * sharpness + 0.15 * darkness
    return _normalize01(_box_blur(depth, r)).astype(np.float32)


def _resize_bilinear(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize of a float map (corner-aligned sample grid)."""
    H, W = x.shape
    yy = np.linspace(0, H - 1, h, dtype=np.float32)
    xx = np.linspace(0, W - 1, w, dtype=np.float32)
    y0 = np.clip(np.floor(yy).astype(np.int64), 0, H - 1)
    x0 = np.clip(np.floor(xx).astype(np.int64), 0, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (yy - y0)[:, None]
    wx = (xx - x0)[None, :]
    top = x[y0][:, x0] * (1 - wx) + x[y0][:, x1] * wx
    bot = x[y1][:, x0] * (1 - wx) + x[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def dpt_estimator(repo_dir: str, dtype=None, device=None) -> Callable:
    """A depth estimator from a local HF DPT snapshot (config.json and
    model.safetensors or pytorch_model.bin), hybrid (Intel/dpt-hybrid-midas,
    the reference notebook's MiDaS) or pure ViT (Intel/dpt-large), on
    ``device`` (the card by default), computing in ``dtype`` (fp32 by
    default).  Returns ``image -> [S, S] float32`` relative inverse depth at
    the model's square size S, the ``estimator=`` of :func:`make_hint`."""
    import torch

    from .models.dpt import DPTDepth, dpt_overrides
    from .weights.convert import load_state_dict
    from .weights.safetensors_file import load_torch

    with open(os.path.join(repo_dir, "config.json")) as f:
        cfg = json.load(f)
    device = torch.device(device or "cuda")
    model = DPTDepth(dtype=dtype or torch.float32, device=device, **dpt_overrides(cfg))
    st = os.path.join(repo_dir, "model.safetensors")
    sd = load_torch(st) if os.path.exists(st) else torch.load(
        os.path.join(repo_dir, "pytorch_model.bin"), map_location="cpu",
        weights_only=False)
    load_state_dict(model, sd, strict=True)
    size = model.image_size

    def estimate(image) -> np.ndarray:
        from PIL import Image

        if not isinstance(image, Image.Image):
            arr = np.asarray(image)
            if arr.dtype != np.uint8:
                arr = np.clip(arr * (255.0 if arr.max() <= 1.5 else 1.0),
                              0, 255).astype(np.uint8)
            image = Image.fromarray(arr)
        im = image.convert("RGB").resize((size, size), Image.BICUBIC)
        x = (np.asarray(im, np.float32)[None] / 255.0 - 0.5) / 0.5
        with torch.inference_mode():
            depth = model(torch.from_numpy(x).to(device))[0]
        return depth.float().cpu().numpy()

    estimate.model = model
    return estimate


def default_estimator(repo_dir: Optional[str] = None) -> Callable:
    """The best estimator at hand: the DPT where ``repo_dir`` (or
    ``$KANDINSKY2_DPT_DIR``) holds a snapshot, else the heuristic."""
    repo_dir = repo_dir or os.environ.get("KANDINSKY2_DPT_DIR")
    if repo_dir and os.path.exists(os.path.join(repo_dir, "config.json")):
        return dpt_estimator(repo_dir)
    return heuristic_depth


def make_hint(image, h: Optional[int] = None, w: Optional[int] = None,
              estimator: Optional[Callable] = None) -> np.ndarray:
    """RGB image -> ControlNet hint [H, W, 3] float32 in [0, 1]: the depth
    map normalised, resized to (h, w) and replicated to 3 channels (the
    reference notebook's ``make_hint``).  ``estimator`` maps an image to an
    HxW depth map; :func:`default_estimator` by default."""
    estimator = estimator or default_estimator()
    depth = np.asarray(estimator(image), np.float32)
    if depth.ndim == 3:
        depth = depth[..., 0]
    depth = _normalize01(depth)
    if h is not None and w is not None and depth.shape != (h, w):
        depth = _resize_bilinear(depth, h, w)
    return np.repeat(depth[..., None], 3, axis=-1).astype(np.float32)
