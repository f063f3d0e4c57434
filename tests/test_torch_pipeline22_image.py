"""The port's Kandinsky 2.2 image tasks against the JAX package's on the CPU
in fp32, at ``tests/test_pipeline22.py``'s TINY shape (and the 64-wide-head
variant for img2img and ControlNet), with the same numpy-seeded parameters
and every noise injected, float images at the end-to-end tolerance:
img2img, ``mix_images`` of a text and an image, inpainting (the 9-channel
UNet), ControlNet with ``hint=`` (and the img2img flow with ``image=``),
the two-stage hires path and ``decode_latents``."""

import numpy as np
import pytest
from PIL import Image

from test_torch_common import (
    assert_images,
    capture_jax_floats22,
    flash_route,
    inject_decoder22,
    inject_prior22,
    parity_pipelines22,
    seeded_noise,
)

PROMPT = "a lighthouse on a cliff"
D = 32  # TINY's embedding width
SIZE = dict(decoder_steps=4, prior_steps=3, h=64, w=64)


def _image(seed):
    return Image.fromarray(
        (np.random.RandomState(seed).rand(64, 64, 3) * 255).astype(np.uint8))


def _prior_noise(seed=1):
    return dict(prior_noise=seeded_noise(seed, 1, D),
                prior_noise_seq=seeded_noise(seed + 1, 3, 1, D))


@pytest.fixture(scope="module")
def pipes():
    return parity_pipelines22()


def _both(jp, tp, monkeypatch, method, *args, **kw):
    capture_jax_floats22(monkeypatch)
    want = getattr(jp, method)(*args, **kw)
    got = getattr(tp, method)(*args, output="float", **kw)
    return got, want


@pytest.mark.parametrize("head", [32, 64])
def test_img2img_matches_jax(monkeypatch, head):
    """Strength 0.5 of 8 DDPM steps: the last 4 run from the re-noised MoVQ
    latent."""
    jp, tp, _ = parity_pipelines22("img2img", head_channels=head)
    if head == 64:
        flash_route(monkeypatch)
    got, want = _both(jp, tp, monkeypatch, "generate_img2img", PROMPT, _image(1),
                      strength=0.5, decoder_steps=8, prior_steps=3, h=64, w=64,
                      noise=seeded_noise(2, 1, 8, 8, 4),
                      noise_seq=seeded_noise(3, 4, 1, 8, 8, 4), **_prior_noise())
    assert_images(got, want, f"img2img head {head}")


def test_mix_images_matches_jax(pipes, monkeypatch):
    jp, tp, _ = pipes
    for pipe in (jp, tp):
        inject_prior22(monkeypatch, pipe, 5)
    got, want = _both(jp, tp, monkeypatch, "mix_images", ["a cat", _image(4)],
                      [0.3, 0.7], noise=seeded_noise(6, 1, 8, 8, 4),
                      noise_seq=seeded_noise(7, 4, 1, 8, 8, 4), **SIZE)
    assert_images(got, want, "mix_images")


def test_inpainting_matches_jax(monkeypatch):
    """The centre repainted (1 = repaint), the UNet fed x ⊕ the masked
    latent ⊕ the keep mask."""
    jp, tp, _ = parity_pipelines22("inpainting")
    assert tp.unet.conv_in.weight.shape[1] == 9
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 16:48] = 1
    got, want = _both(jp, tp, monkeypatch, "generate_inpainting", PROMPT, _image(8),
                      mask, noise=seeded_noise(9, 1, 8, 8, 4),
                      noise_seq=seeded_noise(10, 4, 1, 8, 8, 4), **_prior_noise(), **SIZE)
    assert_images(got, want, "inpainting")


@pytest.mark.parametrize("flow", ["hint", "hint+image"])
@pytest.mark.parametrize("head", [32, 64])
def test_controlnet_matches_jax(monkeypatch, flow, head):
    """The hint through the ControlNet conv stack into 4 latent channels; with
    ``image`` the img2img flow at strength 0.5."""
    jp, tp, _ = parity_pipelines22("controlnet", head_channels=head)
    if head == 64:
        flash_route(monkeypatch)
    hint = np.random.RandomState(11).rand(64, 64, 3).astype(np.float32)
    kw = dict(SIZE, noise=seeded_noise(12, 1, 8, 8, 4), **_prior_noise())
    if flow == "hint+image":
        kw.update(image=_image(13), strength=0.5, decoder_steps=8,
                  noise_seq=seeded_noise(14, 4, 1, 8, 8, 4))
    else:
        kw["noise_seq"] = seeded_noise(14, 4, 1, 8, 8, 4)
    got, want = _both(jp, tp, monkeypatch, "generate_controlnet", PROMPT, hint, **kw)
    assert_images(got, want, f"controlnet {flow} head {head}")


def test_hires_matches_jax(monkeypatch):
    """A 64² stage over 4 DDPM steps, LANCZOS to 128², then the last 0.5 of
    the ladder; the prior's and both stages' noise from numpy seeds."""
    jp, tp, _ = parity_pipelines22()
    for pipe in (jp, tp):  # the prior's per-step noise
        inject_prior22(monkeypatch, pipe, 19)
    inject_decoder22(monkeypatch, jp, 15)
    inject_decoder22(monkeypatch, tp, 15, to_tensor=True)
    got, want = _both(jp, tp, monkeypatch, "generate_text2img_hires", PROMPT,
                      decoder_steps=4, prior_steps=3, h=128, w=128, strength=0.5,
                      noise=seeded_noise(16, 1, 16, 16, 4),
                      prior_noise=seeded_noise(17, 1, D))
    assert got.shape == (1, 128, 128, 3)
    assert_images(got, want, "hires")


def test_decode_latents_matches_jax(pipes, monkeypatch):
    jp, tp, _ = pipes
    lat = seeded_noise(18, 2, 8, 8, 4)
    got, want = _both(jp, tp, monkeypatch, "decode_latents", lat)
    assert_images(got, want, "decode_latents")
