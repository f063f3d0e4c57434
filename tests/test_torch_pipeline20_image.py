"""The port's Kandinsky 2.0 image tasks against the JAX package's on the
CPU in fp32, at ``tests/test_pipeline20.py``'s tiny shape, with the same
numpy-seeded parameters and every noise injected: img2img (DDIM's
truncated ladder with its q_sample re-noising on the default linear
schedule, and the p_sampler's respaced ``timestep_map`` step) and
inpainting (the 9-channel UNet, the mask resized by index arithmetic; the
p_sampler's threshold-and-blend ``denoised_fn``).  Both entry points work
at 512², as the reference's.

The KL posterior draw of ``_vae_encode_sample`` takes no injected noise
in the JAX package, so both pipelines' ``_vae_encode_sample`` are
replaced, here only, by mean + exp(logvar / 2) · n of one seeded n, from
each package's own ``AutoencoderKL.encode`` (held at 1e-4 in
``test_torch_vae_kl.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_common import (
    assert_images,
    capture_jax_floats20,
    parity_pipelines20,
    seeded_noise,
)

PROMPT = "a lighthouse on a cliff"
STEPS = 10
POSTERIOR_NOISE = seeded_noise(5, 1, 64, 64, 4)  # a 512² image's latent


def _image(seed):
    low = np.random.RandomState(seed).randint(0, 256, (16, 16, 3), np.uint8)
    return Image.fromarray(low).resize((96, 96), Image.BICUBIC)


def _fix_posterior(monkeypatch, jp, tp):
    enc = jax.jit(lambda p, x: jp.image_encoder.apply(
        {"params": p}, x, method=type(jp.image_encoder).encode))

    def jax_sample(image):
        mean, logvar = enc(jp.params["image_encoder"], jnp.asarray(image))
        return mean + jnp.exp(0.5 * logvar) * POSTERIOR_NOISE

    def torch_sample(image, generator=None):
        mean, logvar = tp.image_encoder.encode(torch.as_tensor(image))
        return mean + torch.exp(0.5 * logvar) * torch.from_numpy(POSTERIOR_NOISE)

    monkeypatch.setattr(jp, "_vae_encode_sample", jax_sample)
    monkeypatch.setattr(tp, "_vae_encode_sample", torch_sample)
    capture_jax_floats20(monkeypatch)


@pytest.fixture(scope="module")
def pipes():
    return parity_pipelines20()


@pytest.fixture(scope="module")
def pipes_inpaint():
    return parity_pipelines20("inpainting")


# sampler: per-step noise draws at strength 0.7 of 10 steps (DDIM: the
# ladder entries t <= 300; the p_sampler: int(10 · 0.3) respaced steps)
IMG2IMG = {"ddim_sampler": 3, "p_sampler": 3}


@pytest.mark.parametrize("sampler", list(IMG2IMG))
def test_img2img_matches_jax(pipes, monkeypatch, sampler):
    jp, tp, _ = pipes
    _fix_posterior(monkeypatch, jp, tp)
    kw = dict(strength=0.7, num_steps=STEPS, guidance_scale=4, sampler=sampler,
              noise=seeded_noise(6, 1, 64, 64, 4),
              noise_seq=seeded_noise(7, IMG2IMG[sampler], 1, 64, 64, 4))
    want = jp.generate_img2img(PROMPT, _image(1), **kw)
    got = tp.generate_img2img(PROMPT, _image(1), output="float", **kw)
    assert got.shape == (1, 512, 512, 3)
    assert_images(got, want, f"img2img {sampler}")


INPAINT = {
    "ddim_sampler": dict(sampler="ddim_sampler"),
    "p_sampler dynamic_threshold": dict(sampler="p_sampler"),
    "p_sampler clip_denoised": dict(sampler="p_sampler",
                                    denoised_type="clip_denoised"),
}


@pytest.mark.parametrize("case", list(INPAINT))
def test_inpainting_matches_jax(pipes_inpaint, monkeypatch, case):
    jp, tp, _ = pipes_inpaint
    _fix_posterior(monkeypatch, jp, tp)
    mask = np.ones((96, 96), np.float32)
    mask[20:70, 30:90] = 0.0  # 0 = inpaint
    kw = dict(num_steps=STEPS, guidance_scale=4, noise=seeded_noise(8, 1, 64, 64, 4),
              noise_seq=seeded_noise(9, STEPS, 1, 64, 64, 4), **INPAINT[case])
    want = jp.generate_inpainting(PROMPT, _image(2), mask, **kw)
    got = tp.generate_inpainting(PROMPT, _image(2), mask, output="float", **kw)
    assert_images(got, want, f"inpainting {case}")
