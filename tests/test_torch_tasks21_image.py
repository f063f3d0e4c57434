"""The 2.1 image tasks in the port against the JAX package: img2img (DDIM
and the p_sampler), inpainting, ``mix_images``, the two-stage hires path
and turbo (the deep cache), on the ``small_config`` pipeline in fp32 on
the CPU with the same parameters and the same injected noise, float
images at ``E2E_TOL``; and the cached UNet call against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_common import (
    MODULE_TOL,
    assert_close,
    assert_images,
    capture_jax_floats,
    inject_decoder_noise,
    inject_prior_noise,
    parity_pipelines,
    seeded_noise,
)

PROMPT = "red sand dunes"
CLIP_DIM = 64  # small_config's


@pytest.fixture(scope="module")
def pipes():
    jp, tp, _ = parity_pipelines()
    return jp, tp


@pytest.fixture(scope="module")
def hires_pipes():
    jp, tp, _ = parity_pipelines(unet_out_scale=0.1)
    return jp, tp


@pytest.fixture(scope="module")
def inpaint_pipes():
    jp, tp, _ = parity_pipelines(task_type="inpainting", seed=13)
    return jp, tp


def _image(seed, size=64):
    rng = np.random.RandomState(seed)
    return Image.fromarray(rng.randint(0, 256, (size, size, 3), np.uint8))


def _img2img(sampler):
    def run(pipe, out):
        # p_sampler: respaced to 10 steps, strength 0.7 runs the last 3
        nseq = ({"noise_seq": seeded_noise(32, 3, 1, 8, 8, 4)}
                if sampler == "p_sampler" else {})
        return pipe.generate_img2img(
            PROMPT, _image(30), strength=0.7, num_steps=20 if sampler == "ddim_sampler"
            else 10, guidance_scale=4, h=64, w=64, sampler=sampler, prior_steps="5",
            noise=seeded_noise(31, 1, 8, 8, 4), **nseq, **out)
    return run


def _mix(pipe, out):
    return pipe.mix_images(["a violet sky", _image(40)], [0.3, 0.7], num_steps=10,
                           guidance_scale=4, h=64, w=64, prior_steps="5",
                           noise=seeded_noise(41, 1, 8, 8, 4), **out)


def _hires(pipe, out):
    # 64² for the whole ladder, then 128² from t = 350: four DDIM steps
    return pipe.generate_text2img_hires(
        PROMPT, num_steps=10, guidance_scale=4, h=128, w=128, strength=0.65,
        prior_steps="5", noise=seeded_noise(50, 1, 16, 16, 4), **out)


def _turbo(interval, sampler):
    def run(pipe, out):
        return pipe.generate_text2img(
            PROMPT, num_steps=10, guidance_scale=4, h=64, w=64, sampler=sampler,
            prior_steps="5", turbo_interval=interval,
            noise=seeded_noise(60, 1, 8, 8, 4),
            prior_noise=seeded_noise(61, 1, CLIP_DIM),
            prior_noise_seq=seeded_noise(62, 5, 1, CLIP_DIM), **out)
    return run


CASES = {
    "img2img ddim": _img2img("ddim_sampler"),
    "img2img p_sampler": _img2img("p_sampler"),
    "mix_images": _mix,
    "turbo 1": _turbo(1, "dpmpp_sampler"),
    "turbo 3 ddim": _turbo(3, "ddim_sampler"),
    "turbo 3 plms": _turbo(3, "plms_sampler"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_image_task_matches_jax(pipes, monkeypatch, case):
    jp, tp = pipes
    capture_jax_floats(monkeypatch)
    for pipe in (jp, tp):
        inject_prior_noise(monkeypatch, pipe, 20, CLIP_DIM)
        inject_decoder_noise(monkeypatch, pipe, 22)
    want = CASES[case](jp, {})
    got = CASES[case](tp, {"output": "float"})
    assert_images(got, want, case)


def test_hires_matches_jax(hires_pipes, monkeypatch):
    """The two-stage hires path, with the UNet's output conv scaled by 0.1
    (the reference zero-initialises it).  At full scale the random UNet's
    eps under CFG 4 drives the low stage's latent to |z| ~ 78, and the
    decoded images differ from JAX's by 6e-2: a GroupNorm whose group mean
    lies many standard deviations from zero loses digits to its one-pass
    variance (Σx²/n − mean² in fp32), in K1, its plain version and JAX's
    ``_moments`` alike, and exact statistics in the port alone move that
    image by as much (PERF.md, open questions)."""
    jp, tp = hires_pipes
    capture_jax_floats(monkeypatch)
    for pipe in (jp, tp):
        inject_prior_noise(monkeypatch, pipe, 20, CLIP_DIM)
        inject_decoder_noise(monkeypatch, pipe, 22)  # the low stage
    assert_images(_hires(tp, {"output": "float"}), _hires(jp, {}), "hires")


@pytest.mark.parametrize("sampler", ["ddim_sampler", "p_sampler"])
def test_inpainting_matches_jax(inpaint_pipes, monkeypatch, sampler):
    """The inpainting UNet (9 input channels), the mask resized nearest to
    the latent and eroded; the p_sampler also blends x0 with the image."""
    jp, tp = inpaint_pipes
    capture_jax_floats(monkeypatch)
    for pipe in (jp, tp):
        inject_prior_noise(monkeypatch, pipe, 23, CLIP_DIM)
    mask = np.ones((64, 64), np.float32)
    mask[:, 32:] = 0.0  # keep the left half
    mask[10:20, 5:12] = 0.0
    kw = dict(num_steps=10, guidance_scale=4, h=64, w=64, sampler=sampler,
              prior_steps="5", noise=seeded_noise(70, 1, 8, 8, 4))
    if sampler == "p_sampler":
        kw["noise_seq"] = seeded_noise(71, 10, 1, 8, 8, 4)
    want = jp.generate_inpainting(PROMPT, _image(72), mask, **kw)
    got = tp.generate_inpainting(PROMPT, _image(72), mask, output="float", **kw)
    assert_images(got, want, f"inpainting {sampler}")


@pytest.mark.parametrize("refresh", [True, False])
def test_denoise_cached_matches_jax(inpaint_pipes, refresh):
    """One cached call of the inpainting UNet against JAX's at 1e-4: with
    ``refresh`` it recomputes the deep branch (and equals ``denoise``),
    without it the given cache is used."""
    from kandinsky2_tpu.models.unet import deep_cache_spec as jspec
    from kandinsky2_tpu_torch.models.unet import deep_cache_spec

    jp, tp = inpaint_pipes
    ds, ch = deep_cache_spec(tp.unet)
    assert (ds, ch) == jspec(jp.unet)
    mc = tp.config["model_config"]
    a = seeded_noise
    x, img, cache = a(80, 2, 8, 8, 4), a(81, 2, 8, 8, 4), a(82, 2, 8 // ds, 8 // ds, ch)
    mask = (a(83, 2, 8, 8, 1) > 0).astype(np.float32)
    t = np.array([981.0, 301.0], np.float32)
    cond = (a(84, 2, 77, mc["text_encoder_in_dim1"]), a(85, 2, mc["text_encoder_in_dim2"]),
            a(86, 2, mc["image_encoder_in_dim"]))
    unet = jp.unet
    variables = {"params": jp.params["unet"]}
    xf = unet.apply(variables, *map(jnp.asarray, cond),
                    method=type(unet).encode_conditioning)
    want, want_cache = unet.apply(
        variables, jnp.asarray(x), jnp.asarray(t), *xf, jnp.asarray(img),
        jnp.asarray(mask), jnp.asarray(cache), refresh,
        method=type(unet).denoise_cached)
    T = torch.from_numpy
    with torch.inference_mode():
        txf = tp.unet.encode_conditioning(*map(T, cond))
        got, got_cache = tp.unet.denoise_cached(T(x), T(t), *txf, T(img), T(mask),
                                                T(cache), refresh)
        plain = tp.unet.denoise(T(x), T(t), *txf, T(img), T(mask))
    assert_close(got, want, MODULE_TOL, "out")
    assert_close(got_cache, want_cache, MODULE_TOL, "cache")
    if refresh:
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
    else:
        np.testing.assert_array_equal(got_cache.numpy(), cache)


def test_inpainting_model_factory_matches_jax():
    """``create_model(inpainting=True)``: 2C + 1 input channels, the same
    parameter tree as JAX's ``InpaintText2ImUNet21``."""
    from kandinsky2_tpu import configs as jcfg
    from kandinsky2_tpu_torch import configs as tcfg
    from kandinsky2_tpu_torch.weights.from_jax import plan

    mc = dict(tcfg.small_config()["model_config"], inpainting=True)
    unet = tcfg.create_model(**mc, dtype=torch.float32, device="meta")
    assert type(unet).__name__ == "InpaintText2ImUNet21"
    assert unet.input_blocks[0][0].weight.shape[1] == 9
    junet = jcfg.create_model(**mc, dtype=jnp.float32)
    z = jnp.zeros
    shapes = jax.eval_shape(
        lambda k: junet.init(k, z((1, 8, 8, 4)), z((1,)),
                             full_emb=z((1, 77, mc["text_encoder_in_dim1"])),
                             pooled_emb=z((1, mc["text_encoder_in_dim2"])),
                             image_emb=z((1, mc["image_encoder_in_dim"])),
                             inpaint_image=z((1, 8, 8, 4)),
                             inpaint_mask=z((1, 8, 8, 1))),
        jax.random.PRNGKey(0))["params"]
    target = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    assert set(plan(shapes, target)) == set(target)
