"""The port's Kandinsky 2.2 pipeline against the JAX package's on the CPU in
fp32, at ``tests/test_pipeline22.py``'s TINY shape and a variant with
64-wide UNet heads (its attention down K3's route, the kernel's plain
version), with the same numpy-seeded parameters and every noise injected:
text2img through each decoder sampler and prior sampler, turbo, a negative
decoder prompt, ``run_prior`` and ``run_prior_emb2emb``; float images at
the end-to-end tolerance, embeddings at the sampler-loop tolerance; and
the guard errors of both.  The image tasks are in
``test_torch_pipeline22_image.py``."""

import numpy as np
import pytest
import torch

from test_torch_common import (
    assert_close,
    assert_images,
    capture_jax_floats22,
    flash_route,
    inject_prior22,
    parity_pipelines22,
    seeded_noise,
)

PROMPT = "red sand dunes under a violet sky"
LOOP_TOL = 1e-5  # per sampler loop, fp32 (PARITY.md)
D = 32  # TINY's embedding width


@pytest.fixture(scope="module")
def pipes():
    return parity_pipelines22()


@pytest.fixture(scope="module")
def pipes64():
    return parity_pipelines22(head_channels=64)


def _noise(decoder_steps=4, prior_steps=3, seed=0, sampler="ddpm", prior_sampler="ddpm"):
    kw = dict(noise=seeded_noise(seed, 1, 8, 8, 4),
              prior_noise=seeded_noise(seed + 1, 1, D))
    if sampler == "ddpm":
        kw["noise_seq"] = seeded_noise(seed + 2, decoder_steps, 1, 8, 8, 4)
    if prior_sampler == "ddpm":
        kw["prior_noise_seq"] = seeded_noise(seed + 3, prior_steps, 1, D)
    return kw


def _text2img(jp, tp, monkeypatch, **kw):
    capture_jax_floats22(monkeypatch)
    args = dict(decoder_steps=4, prior_steps=3, h=64, w=64)
    args.update(kw)
    want = jp.generate_text2img(PROMPT, **args)
    got = tp.generate_text2img(PROMPT, output="float", **args)
    return got, want


@pytest.mark.parametrize("head", [32, 64])
def test_text2img_ddpm_matches_jax(pipes, pipes64, monkeypatch, head):
    jp, tp, _ = pipes if head == 32 else pipes64
    calls = flash_route(monkeypatch) if head == 64 else None
    got, want = _text2img(jp, tp, monkeypatch, **_noise())
    assert_images(got, want, f"text2img ddpm head {head}")
    if calls is not None:  # 6 UNet attentions a call, 2 CFG halves in one batch
        assert len(calls) >= 4 * 6 and all(q[-1] == 64 for q, _ in calls[:24])


@pytest.mark.parametrize("sampler,prior_sampler", [
    ("dpmpp", "ddpm"), ("dpmpp_karras", "ddpm"), ("ddpm", "dpmpp"),
    ("dpmpp", "dpmpp")])
def test_text2img_samplers_match_jax(pipes, monkeypatch, sampler, prior_sampler):
    jp, tp, _ = pipes
    got, want = _text2img(jp, tp, monkeypatch, sampler=sampler,
                          prior_sampler=prior_sampler,
                          **_noise(sampler=sampler, prior_sampler=prior_sampler))
    assert_images(got, want, f"text2img {sampler} / prior {prior_sampler}")


def test_text2img_turbo_matches_jax(pipes, monkeypatch):
    """The deep cache every 3 of 6 DDPM steps."""
    jp, tp, _ = pipes
    got, want = _text2img(jp, tp, monkeypatch, decoder_steps=6, turbo_interval=3,
                          **_noise(decoder_steps=6))
    assert_images(got, want, "text2img turbo")


def test_text2img_negative_decoder_prompt_matches_jax(pipes, monkeypatch):
    """A second prior run gives the negative embedding; its noise drawn from
    the same numpy seed on both sides."""
    jp, tp, _ = pipes
    for pipe in (jp, tp):
        inject_prior22(monkeypatch, pipe, 9)
    got, want = _text2img(jp, tp, monkeypatch, negative_decoder_prompt="blurry",
                          **_noise())
    assert_images(got, want, "text2img negative decoder prompt")


@pytest.mark.parametrize("sampler", ["ddpm", "dpmpp"])
def test_run_prior_matches_jax(pipes, sampler):
    jp, tp, _ = pipes
    kw = dict(noise=seeded_noise(4, 2, D))
    if sampler == "ddpm":
        kw["noise_seq"] = seeded_noise(5, 5, 2, D)
    want = jp.run_prior([PROMPT, "a cat"], 2, 5, 4, "ugly", sampler=sampler, **kw)
    got = tp.run_prior([PROMPT, "a cat"], 2, 5, 4, "ugly", sampler=sampler, **kw)
    assert got.dtype == torch.float32
    assert_close(got, want, LOOP_TOL, f"run_prior {sampler}")


@pytest.mark.parametrize("sampler", ["ddpm", "dpmpp"])
def test_run_prior_emb2emb_matches_jax(pipes, sampler):
    """From a de-normalised embedding, re-noised at strength 0.6 of 5 steps
    (the last 3 run)."""
    jp, tp, _ = pipes
    emb = seeded_noise(6, D)
    kw = dict(noise=seeded_noise(7, 1, D))
    if sampler == "ddpm":
        kw["noise_seq"] = seeded_noise(8, 3, 1, D)
    want = jp.run_prior_emb2emb(emb, PROMPT, strength=0.6, prior_steps=5,
                                sampler=sampler, **kw)
    got = tp.run_prior_emb2emb(emb, PROMPT, strength=0.6, prior_steps=5,
                               sampler=sampler, **kw)
    assert_close(got, want, LOOP_TOL, f"run_prior_emb2emb {sampler}")


def test_zero_embed_and_text_encoder_match_jax(pipes):
    jp, tp, _ = pipes
    assert_close(tp.get_zero_embed(2), jp.get_zero_embed(2), 1e-4, "zero embed")
    jh, jproj, jmask = jp._encode_text(["", PROMPT])
    with torch.inference_mode():
        th, tproj, tmask = tp._encode_text(["", PROMPT])
    assert_close(th, jh, 1e-4, "hidden")
    assert_close(tproj, jproj, 1e-4, "projection")
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


# --- the same guard errors as the JAX pipeline ---------------------------------


@pytest.mark.parametrize("call", [
    lambda p: p.generate_text2img(PROMPT, sampler="plms", decoder_steps=2,
                                  prior_steps=2, h=64, w=64),
    lambda p: p.run_prior(PROMPT, sampler="ddim", prior_steps=2),
    lambda p: p.run_prior(PROMPT, sampler="dpmpp", prior_steps=2,
                          noise_seq=np.zeros((2, 1, D), np.float32)),
    lambda p: p.run_prior(PROMPT, prior_steps=2, noise=np.zeros((2, D), np.float32)),
    lambda p: p.run_prior_emb2emb(np.zeros(D, np.float32), PROMPT, strength=0.1,
                                  prior_steps=5),
    lambda p: p.generate_text2img(PROMPT, sampler="dpmpp", decoder_steps=2,
                                  prior_steps=2, h=64, w=64,
                                  noise_seq=np.zeros((2, 1, 8, 8, 4), np.float32)),
    lambda p: p.generate_img2img(PROMPT, None, strength=0.1, decoder_steps=5,
                                 prior_steps=2, h=64, w=64),
    lambda p: p.generate_controlnet(PROMPT, decoder_steps=2, prior_steps=2,
                                    h=64, w=64),
    lambda p: p.mix_images(["a", "b"], [1.0], decoder_steps=2, prior_steps=2),
], ids=["decoder_sampler", "prior_sampler", "prior_noise_seq_dpmpp", "noise_shape",
        "emb2emb_strength", "decoder_noise_seq_dpmpp", "img2img_strength",
        "controlnet_no_hint", "mix_weights"])
def test_guard_errors_match_jax(pipes, call):
    jp, tp, _ = pipes
    with pytest.raises((ValueError, AssertionError)) as jerr:
        call(jp)
    with pytest.raises(ValueError):
        call(tp)
    # mix_images's guard is an assert in JAX, a ValueError in the port
    assert jerr.type in (ValueError, AssertionError)


def test_task_type_guard_and_controlnet_image_waits_for_depth(monkeypatch, tmp_path):
    """ControlNet with ``image`` and no ``hint`` makes its hint with the
    heuristic estimator (held against JAX in ``test_torch_depth.py``), or,
    where ``$KANDINSKY2_DPT_DIR`` holds a snapshot, with the DPT estimator
    built from it (``test_torch_dpt.py``)."""
    from PIL import Image

    from kandinsky2_tpu_torch.pipelines import Kandinsky2_2
    from kandinsky2_tpu_torch.utils import stub_tokenizer22

    from test_torch_common import TINY22

    with pytest.raises(ValueError):
        Kandinsky2_2(task_type="upscale", device="meta")
    tp = Kandinsky2_2(task_type="controlnet", dtype=torch.float32, overrides=TINY22,
                      tokenizer=stub_tokenizer22(64), device="cpu")
    kw = dict(image=Image.fromarray(np.zeros((64, 64, 3), np.uint8)), decoder_steps=2,
              prior_steps=2, h=64, w=64, output="float")
    monkeypatch.delenv("KANDINSKY2_DPT_DIR", raising=False)
    assert tp.generate_controlnet(PROMPT, **kw).shape == (1, 64, 64, 3)
    (tmp_path / "config.json").write_text("{}")
    monkeypatch.setenv("KANDINSKY2_DPT_DIR", str(tmp_path))
    from kandinsky2_tpu_torch import depth

    built = []

    def dpt_estimator(repo_dir):
        built.append(repo_dir)
        return lambda image: np.tile(np.linspace(1, 0, 64, dtype=np.float32)[:, None],
                                     (1, 64))

    monkeypatch.setattr(depth, "dpt_estimator", dpt_estimator)
    assert tp.generate_controlnet(PROMPT, **kw).shape == (1, 64, 64, 3)
    assert built == [str(tmp_path)]
