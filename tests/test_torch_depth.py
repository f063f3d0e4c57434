"""The port's depth hints (``kandinsky2_tpu_torch/depth.py``) against the
JAX package's ``depth.py`` at 1e-6 — the heuristic estimator and
``make_hint`` on PIL and array images, flat ones too — the estimator
choice (the heuristic with no DPT snapshot, the DPT loader with one),
and the 2.2 ``generate_controlnet(image=...)`` without
``hint=`` against the JAX pipeline's, both deriving the hint from the
image, float images at the end-to-end tolerance."""

import numpy as np
import pytest
from PIL import Image

from kandinsky2_tpu import depth as jdepth
from kandinsky2_tpu_torch import depth as tdepth
from test_torch_common import (
    assert_images,
    capture_jax_floats22,
    parity_pipelines22,
    seeded_noise,
)

TOL = 1e-6


def _photo(size=(96, 80), seed=0):
    rng = np.random.RandomState(seed)
    H, W = size
    yy = np.linspace(0, 1, H, dtype=np.float32)[:, None]
    img = np.stack([0.2 + 0.5 * yy + 0.2 * rng.rand(H, W),
                    0.4 + 0.2 * yy + 0.2 * rng.rand(H, W),
                    0.8 - 0.5 * yy + 0.2 * rng.rand(H, W)], axis=-1)
    return Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))


IMAGES = {
    "pil": lambda: _photo(),
    "uint8 array": lambda: np.asarray(_photo((64, 64), 1)),
    "float array in [0, 1]": lambda: np.asarray(_photo((50, 70), 2), np.float32) / 255,
    "grey": lambda: np.asarray(_photo((40, 40), 3).convert("L")),
    "flat": lambda: Image.fromarray(np.full((32, 32, 3), 128, np.uint8)),
}


@pytest.mark.parametrize("name", list(IMAGES))
def test_heuristic_depth_matches_jax(name):
    img = IMAGES[name]()
    want = jdepth.heuristic_depth(img)
    got = tdepth.heuristic_depth(img)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", list(IMAGES))
@pytest.mark.parametrize("size", [None, (64, 48)])
def test_make_hint_matches_jax(name, size, monkeypatch):
    monkeypatch.delenv("KANDINSKY2_DPT_DIR", raising=False)
    img = IMAGES[name]()
    h, w = size or (None, None)
    want = jdepth.make_hint(img, h=h, w=w)
    got = tdepth.make_hint(img, h=h, w=w)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_default_estimator(monkeypatch, tmp_path):
    monkeypatch.delenv("KANDINSKY2_DPT_DIR", raising=False)
    assert tdepth.default_estimator() is tdepth.heuristic_depth
    # a directory without a snapshot keeps the heuristic
    monkeypatch.setenv("KANDINSKY2_DPT_DIR", str(tmp_path))
    assert tdepth.default_estimator() is tdepth.heuristic_depth
    # a snapshot is loaded as the DPT network (tests/test_torch_dpt.py), never
    # replaced by the heuristic: this one's config lacks the widths
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(KeyError, match="hidden_size"):
        tdepth.default_estimator()
    with pytest.raises(KeyError, match="hidden_size"):
        tdepth.make_hint(_photo())
    monkeypatch.delenv("KANDINSKY2_DPT_DIR")
    with pytest.raises(KeyError, match="hidden_size"):
        tdepth.default_estimator(str(tmp_path))
    grad = lambda img: np.tile(np.linspace(1, 0, 32, dtype=np.float32)[:, None], (1, 32))
    hint = tdepth.make_hint(_photo(), h=32, w=32, estimator=grad)
    np.testing.assert_allclose(hint[0, :, 0], 1.0)


def test_controlnet_image_without_hint_matches_jax(monkeypatch):
    """The ControlnetImg2Img flow: the hint made from ``image`` by
    ``make_hint`` in both packages, the image MoVQ-encoded and re-noised
    at ``strength`` of 8 DDPM steps."""
    monkeypatch.delenv("KANDINSKY2_DPT_DIR", raising=False)
    jp, tp, _ = parity_pipelines22("controlnet")
    capture_jax_floats22(monkeypatch)
    kw = dict(decoder_steps=8, prior_steps=3, h=64, w=64, strength=0.5,
              noise=seeded_noise(12, 1, 8, 8, 4),
              noise_seq=seeded_noise(14, 4, 1, 8, 8, 4),
              prior_noise=seeded_noise(1, 1, 32),
              prior_noise_seq=seeded_noise(2, 3, 1, 32))
    image = _photo((64, 64), 5)
    want = jp.generate_controlnet("a lighthouse on a cliff", image=image, **kw)
    got = tp.generate_controlnet("a lighthouse on a cliff", image=image,
                                 output="float", **kw)
    assert_images(got, want, "controlnet image without hint")
    # the derived hint is the one make_hint gives, not a constant
    assert np.std(tdepth.make_hint(image, h=64, w=64)) > 0.05
