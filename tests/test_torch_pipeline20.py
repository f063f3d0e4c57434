"""The port's Kandinsky 2.0 text2img against the JAX package's on the CPU in
fp32, at ``tests/test_pipeline20.py``'s tiny shape (and its 64-wide-head
variant, routed down K3's path), with the same numpy-seeded parameters and
every noise injected (x_T, and the per-step noise of the p_sampler and of
stochastic DDIM): each of the five samplers, ``decode_latents``, the
pipeline's own generator, and the guards.  Float images at the end-to-end
tolerance.  The image tasks are in ``test_torch_pipeline20_image.py``."""

import numpy as np
import pytest
import torch

from test_torch_common import (
    assert_images,
    capture_jax_floats20,
    flash_route,
    parity_pipelines20,
    seeded_noise,
)

PROMPT = "a red cat on a blue sofa"
STEPS = 5
NOISE = seeded_noise(1, 1, 8, 8, 4)  # x_T of a 64² image


@pytest.fixture(scope="module")
def pipes():
    return parity_pipelines20()


# sampler: (generate_text2img kwargs, draws of per-step noise)
SAMPLERS = {
    "ddim_sampler eta 0.05": (dict(sampler="ddim_sampler"), STEPS),
    "p_sampler": (dict(sampler="p_sampler"), STEPS),
    "plms_sampler": (dict(sampler="plms_sampler"), 0),
    "dpmpp_sampler": (dict(sampler="dpmpp_sampler"), 0),
    "dpmpp_karras_sampler": (dict(sampler="dpmpp_karras_sampler"), 0),
}


@pytest.mark.parametrize("case", list(SAMPLERS))
def test_text2img_matches_jax(pipes, monkeypatch, case):
    jp, tp, _ = pipes
    capture_jax_floats20(monkeypatch)
    extra, draws = SAMPLERS[case]
    kw = dict(num_steps=STEPS, guidance_scale=4, h=64, w=64, noise=NOISE, **extra)
    if draws:
        kw["noise_seq"] = seeded_noise(2, draws, 1, 8, 8, 4)
    want = jp.generate_text2img(PROMPT, **kw)
    got = tp.generate_text2img(PROMPT, output="float", **kw)
    assert_images(got, want, case)


def test_text2img_k3_route_batch2_matches_jax(monkeypatch):
    """64-wide heads, the UNet's attention on K3's route (its plain version
    on the CPU), two prompts, 128², deterministic DDIM (eta 0).  The
    tokens prepended to the spatial K/V are both streams': 38 XLM-R tokens
    at the tiny tower's 40 positions, 77 mT5 tokens."""
    jp, tp, _ = parity_pipelines20(head_channels=64)
    calls = flash_route(monkeypatch)
    capture_jax_floats20(monkeypatch)
    kw = dict(num_steps=STEPS, guidance_scale=4, h=128, w=128, ddim_eta=0.0,
              noise=seeded_noise(3, 2, 16, 16, 4))
    want = jp.generate_text2img([PROMPT, "a green hill"], **kw)
    got = tp.generate_text2img([PROMPT, "a green hill"], output="float", **kw)
    assert_images(got, want, "text2img K3 route batch 2")
    # every UNet attention took K3's route, with both streams' tokens
    assert calls and all(k[1] == q[1] + 38 + 77 for q, k in calls if q[1] != k[1])
    assert {q[1] for q, _ in calls} >= {64}


def test_decode_latents_matches_jax(pipes, monkeypatch):
    jp, tp, _ = pipes
    capture_jax_floats20(monkeypatch)
    lat = 0.05 * seeded_noise(4, 2, 8, 16, 4)
    want = jp.decode_latents(lat)
    got = tp.decode_latents(lat, output="float")
    assert got.shape == (2, 64, 128, 3)
    assert_images(got, want, "decode_latents")


def test_generator_and_set_seed(pipes):
    """Undrawn noise comes from ``generator`` or the pipeline's own,
    which ``set_seed`` resets."""
    _, tp, _ = pipes
    kw = dict(num_steps=STEPS, h=64, w=64, output="float")
    tp.set_seed(7)
    a = tp.generate_text2img(PROMPT, **kw)
    b = tp.generate_text2img(PROMPT, **kw)
    tp.set_seed(7)
    c = tp.generate_text2img(PROMPT, **kw)
    d = tp.generate_text2img(PROMPT, generator=torch.Generator().manual_seed(7), **kw)
    np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(a, d)
    assert np.abs(a - b).max() > 1e-3


@pytest.mark.parametrize("call", [
    lambda p: p.generate_text2img(PROMPT, num_steps=2, h=64, w=64, sampler="euler"),
    lambda p: p.generate_text2img(PROMPT, num_steps=2, h=64, w=64,
                                  sampler="plms_sampler",
                                  noise_seq=np.zeros((2, 1, 8, 8, 4), np.float32)),
    lambda p: p.generate_text2img(PROMPT, num_steps=2, h=64, w=64, ddim_eta=0.0,
                                  noise_seq=np.zeros((2, 1, 8, 8, 4), np.float32)),
], ids=["sampler", "noise_seq_plms", "noise_seq_ddim_eta0"])
def test_guard_errors_match_jax(pipes, call):
    jp, tp, _ = pipes
    with pytest.raises(ValueError):
        call(jp)
    with pytest.raises(ValueError):
        call(tp)


def test_task_type_guard():
    from kandinsky2_tpu_torch.pipelines import Kandinsky2

    with pytest.raises(ValueError):
        Kandinsky2(task_type="controlnet", device="meta")
    assert Kandinsky2(task_type="inpainting", device="meta").unet.input_blocks[0][0] \
        .weight.shape[1] == 9
