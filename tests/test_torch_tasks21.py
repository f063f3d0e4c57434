"""2.1 text2img through every decoder sampler, prior ladder and option, in
the port against the JAX package: the ``small_config`` pipeline in fp32 on
the CPU with the same parameters and the same injected noise (decoder and
prior x_T, per-step noise, and the draws of the staged prior calls), float
images at ``E2E_TOL``.  The image tasks (img2img, inpainting, mix, hires,
turbo) are in ``test_torch_tasks21_image.py``."""

import numpy as np
import pytest

from test_torch_common import (
    E2E_TOL,
    assert_images,
    capture_jax_floats,
    inject_prior_noise,
    parity_pipelines,
    seeded_noise,
)

PROMPT = "red sand dunes"
H = 64  # latent 8x8
STEPS = 10
CLIP_DIM = 64  # small_config's


@pytest.fixture(scope="module")
def pipes():
    jp, tp, _ = parity_pipelines()
    return jp, tp


# name: (generate_text2img kwargs, with the per-step decoder noise)
TEXT2IMG = {
    "p_sampler": (dict(sampler="p_sampler"), True),
    "ddim_sampler": (dict(sampler="ddim_sampler"), False),
    "plms_sampler": (dict(sampler="plms_sampler"), False),
    "dpmpp_sampler": (dict(sampler="dpmpp_sampler"), False),
    "dpmpp_karras_sampler": (dict(sampler="dpmpp_karras_sampler"), False),
    "prior ddim5": (dict(prior_steps="ddim5"), False),
    "prior dpmpp5": (dict(prior_steps="dpmpp5"), False),
    "negative_decoder_prompt": (dict(negative_decoder_prompt="blurry"), False),
}


@pytest.mark.parametrize("case", list(TEXT2IMG))
def test_text2img_matches_jax(pipes, monkeypatch, case):
    jp, tp = pipes
    capture_jax_floats(monkeypatch)
    for pipe in (jp, tp):  # the negative decoder prompt's prior call
        inject_prior_noise(monkeypatch, pipe, 21, CLIP_DIM)
    extra, with_nseq = TEXT2IMG[case]
    kw = dict(num_steps=STEPS, batch_size=1, guidance_scale=4, h=H, w=H,
              sampler="ddim_sampler", prior_cf_scale=4, prior_steps="5",
              noise=seeded_noise(1, 1, H // 8, H // 8, 4),
              prior_noise=seeded_noise(2, 1, CLIP_DIM))
    kw.update(extra)
    if kw["prior_steps"] == "5":
        kw["prior_noise_seq"] = seeded_noise(3, 5, 1, CLIP_DIM)
    if with_nseq:
        kw["noise_seq"] = seeded_noise(4, STEPS, 1, H // 8, H // 8, 4)
    want = jp.generate_text2img(PROMPT, **kw)
    got = tp.generate_text2img(PROMPT, output="float", **kw)
    assert_images(got, want, case)


def test_clip_emb_and_decode_latents_match_jax(pipes, monkeypatch):
    """``generate_clip_emb`` on a batch of two prompts, and
    ``decode_latents``."""
    jp, tp = pipes
    capture_jax_floats(monkeypatch)
    kw = dict(batch_size=2, prior_cf_scale=3, prior_steps="5",
              negative_prior_prompt="low quality",
              noise=seeded_noise(5, 2, CLIP_DIM),
              noise_seq=seeded_noise(6, 5, 2, CLIP_DIM))
    want = np.asarray(jp.generate_clip_emb(["a cat", "a dog"], **kw))
    got = tp.generate_clip_emb(["a cat", "a dog"], **kw).numpy()
    err = float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))
    assert err <= E2E_TOL, f"generate_clip_emb: {err:.3e}"
    lat = seeded_noise(7, 2, 8, 16, 4)
    assert_images(tp.decode_latents(lat, output="float"), jp.decode_latents(lat),
                  "decode_latents")
