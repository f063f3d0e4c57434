"""Host image and mask operations in numpy, the port's own copy of the
numpy versions in ``kandinsky2_tpu/native.py`` (the JAX package also ships
them as a C++ library, ``native/libhostops.so``, which the port does not
load).  They run on the host around the pipeline, not on the card."""

from __future__ import annotations

import numpy as np

# offsets (dy, dx) whose zero forces a pixel to zero: the transpose of the
# write offsets of the reference loop (utils.py:11-30)
_ERODE_OFFSETS = ((1, 0), (0, 1), (1, 1), (-1, 0), (0, -1), (-1, -1))


def f32_to_u8_images(batch: np.ndarray) -> np.ndarray:
    """[-1, 1] float NHWC -> uint8 (utils.py:57-66): round half to even,
    then clamp to [0, 255]."""
    arr = np.asarray(batch, np.float32)
    return np.clip(np.rint((arr + 1.0) * 127.5), 0, 255).astype(np.uint8)


def u8_to_f32_images(batch: np.ndarray) -> np.ndarray:
    """uint8 images -> float32 in [-1, 1]."""
    return np.asarray(batch, np.uint8).astype(np.float32) / 127.5 - 1.0


def erode_mask(mask_hw: np.ndarray) -> np.ndarray:
    """Erode the keep region (1 = keep, 0 = inpaint) of an [H, W] mask:
    every zero pixel zeroes its neighbours at the offsets the reference
    loop writes, {(±1, 0), (0, ±1), (−1, −1), (+1, +1)}."""
    hw = np.asarray(mask_hw, np.float32)
    pad = np.pad(hw, 1, constant_values=1.0)
    out = hw.copy()
    for dy, dx in _ERODE_OFFSETS:
        out = out * pad[1 + dy:1 + dy + hw.shape[0], 1 + dx:1 + dx + hw.shape[1]]
    return (out * hw).astype(np.float32)
