"""Output-fidelity metrics for validating checkpoints and conversions, the
counterpart of ``kandinsky2_tpu/eval.py``:

* ``psnr`` / ``ssim`` / ``ms_ssim``: classical pixel metrics on numpy
  arrays (11x11 Gaussian windows; MS-SSIM with the 2003 scale weights and
  fewer scales below 11·2⁴ pixels), copies of the JAX package's;
* ``clip_perceptual_distance``: cosine distance between the pooled CLIP
  image embeddings of the pipeline's own vision tower, a semantic drift
  gate and not LPIPS (one pooled embedding does not resolve
  0.02-level texture differences; ``lpips.py`` is the LPIPS gate);
* ``latent_rmse`` in torch.
"""

from __future__ import annotations

import numpy as np
import torch


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(data_range) - 10 * np.log10(mse))


def _gaussian_kernel1d(sigma: float = 1.5, radius: int = 5) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _filter2d(img: np.ndarray, k1d: np.ndarray) -> np.ndarray:
    """Separable 'valid' Gaussian filter over the leading two (H, W) axes."""
    out = np.apply_along_axis(
        lambda r: np.convolve(r, k1d, mode="valid"), 0, img
    )
    return np.apply_along_axis(
        lambda r: np.convolve(r, k1d, mode="valid"), 1, out
    )


def _ssim_cs_maps(a: np.ndarray, b: np.ndarray, data_range: float,
                  sigma: float = 1.5):
    """(ssim_map, contrast-structure map) with 11x11 Gaussian windows."""
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    k = _gaussian_kernel1d(sigma)
    mu_a = _filter2d(a, k)
    mu_b = _filter2d(b, k)
    va = _filter2d(a * a, k) - mu_a**2
    vb = _filter2d(b * b, k) - mu_b**2
    cov = _filter2d(a * b, k) - mu_a * mu_b
    cs_map = (2 * cov + c2) / (va + vb + c2)
    lum = (2 * mu_a * mu_b + c1) / (mu_a**2 + mu_b**2 + c1)
    return lum * cs_map, cs_map


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0,
         sigma: float = 1.5) -> float:
    """Windowed SSIM (Wang et al. 2004): 11x11 Gaussian local statistics
    averaged over positions and channels — the standard formulation, not a
    single global window."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    ssim_map, _ = _ssim_cs_maps(a, b, data_range, sigma)
    return float(ssim_map.mean())


# Wang et al. 2003 published scale weights
_MSSSIM_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])


def ms_ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0,
            sigma: float = 1.5) -> float:
    """Multi-Scale SSIM (Wang et al. 2003): contrast-structure terms at up
    to 5 dyadic scales (2x average-pool between scales), the luminance term
    at the coarsest, combined as the weighted geometric mean.  More
    texture-sensitive than single-scale SSIM — the strongest perceptual
    proxy available offline (the BASELINE LPIPS gate still needs the lpips
    package + weights; validate.py labels both honestly).  Images smaller
    than 11·2^4 use fewer scales with the weights renormalized."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    # each scale needs >= the 11-pixel window after its downsamples
    max_scales = 0
    side = min(a.shape[0], a.shape[1])
    while max_scales < 5 and side >= 11:
        max_scales += 1
        side //= 2
    if max_scales == 0:
        raise ValueError(f"image {a.shape} smaller than the 11px SSIM window")
    w = _MSSSIM_WEIGHTS[:max_scales]
    w = w / w.sum()

    vals = []
    for i in range(max_scales):
        ssim_map, cs_map = _ssim_cs_maps(a, b, data_range, sigma)
        if i == max_scales - 1:
            vals.append(max(float(ssim_map.mean()), 1e-12))
        else:
            vals.append(max(float(cs_map.mean()), 1e-12))
            h2, w2 = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
            a = a[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2, -1).mean((1, 3))
            b = b[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2, -1).mean((1, 3))
    return float(np.prod([v ** wi for v, wi in zip(vals, w)]))


def clip_perceptual_distance(pipe, img_a, img_b) -> float:
    """Semantic drift: 1 - cosine similarity of pooled CLIP image embeddings
    computed with the pipeline's own vision tower.  ``img_a``/``img_b`` are
    PIL images.  Coarser than LPIPS (see module docstring)."""
    with torch.inference_mode():
        ea, eb = (pipe.encode_images(im, is_pil=True).double().cpu().numpy()[0]
                  for im in (img_a, img_b))
    cos = float(
        np.dot(ea, eb) / (np.linalg.norm(ea) * np.linalg.norm(eb) + 1e-12)
    )
    return 1.0 - cos


def latent_rmse(a, b) -> float:
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    return float(torch.sqrt(torch.mean((a - b) ** 2)))
