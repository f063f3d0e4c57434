"""Row-sharded Kandinsky 2.1 inference in the port (``sp_mesh=`` on the 2.1
entry points) on the CPU in fp32, over one pool of four gloo ranks
(``torch_sp_ranks``, the rank side): every rank builds the
``small_config`` pipeline from the same numpy-seeded parameters and calls
the entry point with the same arguments.

* ``generate_img`` (DDIM, and the p_sampler with its per-step noise
  injected) and ``decode_latents`` on 2 and 4 ranks against the JAX
  pipeline with the same injected noise, at ``E2E_TOL``;
* the other entry points (text2img, img2img, inpainting, mix, hires,
  turbo) against the same call unsharded on the ranks (each of those is
  held against JAX's in ``test_torch_tasks21*.py``), at ``E2E_TOL``; the
  p_sampler drawing its own noise (a stream per rank) finite;
* the error for a latent height that does not keep equal even shards.
"""

import types

import numpy as np
import pytest
from PIL import Image

import torch_sp_ranks as ranks
from kandinsky2_tpu_torch.parallel.launch import RankPool
from test_torch_common import (
    assert_images,
    capture_jax_floats,
    parity_pipelines,
    seeded_noise,
    small_config,
)

PROMPT = "red sand dunes"
CLIP_DIM = 64  # small_config's
H = 128  # latent 16x16: 4 rows a rank at 4 ranks, 2 at the UNet's second level


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, device="cpu")
    p.start()  # the ranks join while the JAX side compiles
    yield p
    p.close()


def _clip():
    rng = np.random.RandomState(11)  # parity_pipelines' CLIP statistics
    return ((0.1 * rng.randn(CLIP_DIM)).astype(np.float32),
            (1 + 0.1 * rng.rand(CLIP_DIM)).astype(np.float32))


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, the port's rank-side arguments, the port's pipeline
    in this process) for text2img and inpainting."""
    out = {}
    for task, seed in (("text2img", 12), ("inpainting", 13)):
        jp, tp, params = parity_pipelines(task_type=task, seed=seed)
        out[task] = (jp, (task, params, small_config(), _clip()), tp)
    # the hires cases' pipeline (test_torch_tasks21_image.py's): the UNet's
    # output conv scaled by 0.1, so that the 8-bit images between the two
    # stages do not magnify float drift at a rounding edge
    _, tp, params = parity_pipelines(unet_out_scale=0.1)
    out["hires"] = (None, ("hires", params, small_config(), _clip()), tp)
    return out


def _img_prompt(seed):
    return np.concatenate([seeded_noise(seed, 1, CLIP_DIM),
                           np.zeros((1, CLIP_DIM), np.float32)])


GEN_IMG = {
    "ddim sp4": (4, dict(sampler="ddim_sampler", num_steps=4)),
    "ddim sp2": (2, dict(sampler="ddim_sampler", num_steps=4)),
    "p_sampler noise_seq sp4": (4, dict(sampler="p_sampler", num_steps=4,
                                        noise_seq=seeded_noise(3, 4, 1, 16, 16, 4))),
}


@pytest.mark.parametrize("case", list(GEN_IMG))
def test_generate_img_sp_matches_jax(pool, pipes, monkeypatch, case):
    n, extra = GEN_IMG[case]
    jp, args, _ = pipes["text2img"]
    capture_jax_floats(monkeypatch)
    kw = dict(prompt="a cat", img_prompt=_img_prompt(1), batch_size=1,
              guidance_scale=4, h=H, w=H, noise=seeded_noise(2, 1, 16, 16, 4), **extra)
    want = jp.generate_img(**kw)
    got = pool.run(ranks.pipeline, n, *args, "generate_img", kw)[0]
    assert_images(got, want, f"generate_img {case}")


@pytest.mark.parametrize("n", [2, 4])
def test_decode_latents_sp_matches_jax(pool, pipes, monkeypatch, n):
    jp, args, _ = pipes["text2img"]
    capture_jax_floats(monkeypatch)
    lat = seeded_noise(7, 2, 16, 8, 4)
    want = jp.decode_latents(lat)
    got = pool.run(ranks.pipeline, n, *args, "decode_latents", dict(latents=lat))[0]
    assert_images(got, want, f"decode_latents sp{n}")


def _image(seed, size=H):
    rng = np.random.RandomState(seed)
    return Image.fromarray(rng.randint(0, 256, (size, size, 3), np.uint8))


_COMMON = dict(num_steps=4, guidance_scale=4, h=H, w=H, prior_steps="5")
_MASK = np.ones((H, H), np.float32)
_MASK[30:90, 20:100] = 0.0
# entry point, task type, kwargs (every noise drawn from the pipeline's
# generator, reset on every rank before the call)
ENTRY = {
    "text2img": ("generate_text2img", "text2img", dict(prompt=PROMPT, **_COMMON)),
    "img2img": ("generate_img2img", "text2img",
                dict(prompt=PROMPT, pil_img=_image(30), strength=0.7, **_COMMON)),
    "inpainting": ("generate_inpainting", "inpainting",
                   dict(prompt=PROMPT, pil_img=_image(31), img_mask=_MASK, **_COMMON)),
    "mix_images": ("mix_images", "text2img",
                   dict(images_texts=[PROMPT, _image(32)], weights=[0.6, 0.4],
                        **_COMMON)),
    "hires": ("generate_text2img_hires", "hires",
              dict(prompt=PROMPT, low_scale=0.5, strength=0.65, **_COMMON)),
    "turbo": ("generate_img", "text2img",
              dict(prompt="a cat", img_prompt=_img_prompt(4), turbo_interval=2,
                   num_steps=4, h=H, w=H)),
}


@pytest.mark.parametrize("case", list(ENTRY))
def test_entry_point_sp_matches_unsharded(pool, pipes, case):
    entry, task, kw = ENTRY[case]
    args = pipes[task][1]
    whole = pool.run(ranks.pipeline, 0, *args, entry, kw, seed=5)[0]
    got = pool.run(ranks.pipeline, 4, *args, entry, kw, seed=5)[0]
    assert_images(got, whole, f"{case} sp4 vs unsharded")


def test_p_sampler_own_noise_sp_is_finite(pool, pipes):
    """The p_sampler drawing its per-step noise itself: each rank its own
    stream (the dynamic threshold over the whole image)."""
    kw = dict(prompt="a cat", img_prompt=_img_prompt(6), sampler="p_sampler",
              num_steps=4, h=H, w=H)
    got = pool.run(ranks.pipeline, 4, *pipes["text2img"][1], "generate_img", kw)[0]
    assert got.shape == (1, H, H, 3)
    assert np.isfinite(got).all() and np.std(got) > 1e-3


def test_generate_img_sp_rejects_bad_rows(pipes):
    """A latent height that does not keep equal even shards at every UNet
    level raises before anything runs (the row check needs only the
    mesh's size)."""
    tp = pipes["text2img"][2]
    mesh16 = types.SimpleNamespace(shape={"sp": 16})
    with pytest.raises(ValueError, match="sp_axis"):
        tp.generate_img(prompt="x", img_prompt=_img_prompt(1), batch_size=1,
                        h=H, w=H, sampler="ddim_sampler", num_steps=2, sp_mesh=mesh16)
