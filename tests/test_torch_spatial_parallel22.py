"""Row-sharded Kandinsky 2.2 and 2.0 inference and sharded LoRA tuning of
the UNet22 in the port, on the CPU in fp32, over one pool of four gloo
ranks (``torch_sp22_ranks``, the rank side).  The JAX side runs in this
process on the virtual devices of ``tests/conftest.py``.  Held here:

* the row-sharded ``UNet22`` (tiny, 64-wide heads; its up and down
  blocks, the ControlNet hint encoded whole, the 9-channel inpainting
  input) against JAX's unsharded module (``MODULE_TOL``) and the port's
  unsharded one (1e-5); ``denoise_cached`` sharded against unsharded;
* every 2.2 entry point with ``sp_mesh=`` against the same call unsharded
  on the ranks (1e-4), the decoder's draws injected as
  ``test_torch_common.inject_decoder22`` injects them; the 2.2 decoder
  loop sharded against JAX's unsharded ``_decode_loop`` (``E2E_TOL``);
* every 2.0 entry point with ``sp_mesh=`` (DDIM at eta 0.05, the p_sampler
  with its dynamic threshold over the whole image, PLMS, img2img,
  inpainting, ``decode_latents``) against unsharded (1e-4), and text2img
  against JAX's (``E2E_TOL``);
* a latent height that does not keep equal even shards refused;
* two ``optax.sgd`` steps of ``make_sp_lora_train_fn`` on a (data 2, sp 2)
  mesh against JAX's ``make_sp_lora_train_fn`` on 4 virtual devices
  (compiled once, on a thread, while the ranks run the cases before it),
  with JAX's t and noise draws handed to the ranks: losses and factors
  within 1e-5, the factors bitwise equal across the ranks, the base
  unchanged; the added-KV attention on K3's route (the flash kernels'
  plain versions, forward and backward, on local query rows against
  gathered K/V).
"""

import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh
from PIL import Image

import torch_sp22_ranks as ranks
from kandinsky2_tpu.models import lora as jlora
from kandinsky2_tpu.models import unet22 as junet22
from kandinsky2_tpu.train import train_lora as jtrain
from kandinsky2_tpu_torch.configs import small_config20
from kandinsky2_tpu_torch.diffusion.schedules import ddim_ladder
from kandinsky2_tpu_torch.parallel.launch import RankPool
from kandinsky2_tpu_torch.train.train_lora import flatten_loras
from kandinsky2_tpu_torch.weights.from_jax import lora_from_jax
from test_torch_common import (
    MODULE_TOL,
    assert_close,
    assert_images,
    capture_jax_floats20,
    capture_jax_floats22,
    numpy_params,
    parity_pipelines20,
    parity_pipelines22,
    seeded_noise,
    tiny22,
)

PROMPT = "red sand dunes"
H = 128  # latent 16 x 16: 4 rows a rank at 4 ranks, 2 at the UNet's second level
TINY = tiny22(64)
WIDE = TINY["unet"]
SP_TOL = 1e-4  # an entry point sharded against unsharded, fp32
LORA_TOL = 1e-5
SHAPE, LR = (2, 2), 0.05
ACP = np.cumprod(1.0 - np.linspace(0.00085, 0.012, 1000)).astype(np.float32)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, device="cpu")
    p.start()  # the ranks join while the JAX side compiles
    yield p
    p.close()


@pytest.fixture(scope="module", autouse=True)
def jax_lora_started():
    """JAX's sharded LoRA steps (``_jax_sp_lora``), traced and compiled on a
    thread of their own from the module's start."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_jax_sp_lora)


# --- the UNet22 -------------------------------------------------------------------

UNET_CASES = {
    "text2img": dict(),
    "controlnet hint": dict(in_channels=8, controlnet_hint=True),
    "inpainting 9 channels": dict(in_channels=9),
}


def _jax_unet(case, seed, apply=True):
    """(port kwargs, numpy params, inputs, JAX's unsharded output, where
    ``apply``)."""
    kw = dict(WIDE, **UNET_CASES[case])
    ju = junet22.UNet22(**kw)
    c_x = 9 if kw.get("in_channels") == 9 else 4
    x = seeded_noise(seed, 2, 16, 16, c_x)
    t = np.array([10.0, 700.0], np.float32)
    emb = seeded_noise(seed + 1, 2, WIDE["encoder_hid_dim"])
    hint = (np.random.RandomState(seed + 2).rand(2, H, H, 3).astype(np.float32)
            if kw.get("controlnet_hint") else None)
    shapes = jax.eval_shape(ju.init, jax.random.PRNGKey(0), x, t, emb, hint)
    params = numpy_params(shapes["params"], seed + 3)
    want = (np.asarray(jax.jit(ju.apply)({"params": params}, x, t, emb, hint)) if apply
            else None)
    return kw, params, (x, t, emb, hint), want


@pytest.mark.parametrize("case", list(UNET_CASES))
def test_unet22_sp_matches_jax(pool, case):
    kw, params, (x, t, emb, hint), want = _jax_unet(case, 40)
    got, whole = pool.run(ranks.unet22, 4, kw, params, x, t, emb, hint)[0]
    assert_close(got, want, MODULE_TOL, f"sharded UNet22 {case} vs JAX")
    assert_close(got, whole, 1e-5, f"sharded UNet22 {case} vs unsharded")


def test_unet22_denoise_cached_sp_matches_unsharded(pool):
    """Both calls' outputs and the deep cache (this rank's rows of it
    where sharded, gathered here)."""
    kw, params, (x, t, emb, _), _ = _jax_unet("text2img", 50, apply=False)
    got, whole = pool.run(ranks.unet22_cached, 4, kw, params, x, t, emb)[0]
    for name, a, b in zip(("refresh", "from the cache", "cache"), got, whole):
        assert_close(a, b, 1e-5, f"denoise_cached {name}")


# --- the 2.2 entry points ---------------------------------------------------------


def _image(seed, size=H):
    rng = np.random.RandomState(seed)
    return Image.fromarray(rng.randint(0, 256, (size, size, 3), np.uint8))


_MASK = np.zeros((H, H), np.float32)
_MASK[30:90, 20:100] = 1.0  # 1 = repaint
_C22 = dict(decoder_steps=3, prior_steps=3, h=H, w=H)
# entry point, task type, kwargs (the decoder's draws injected on every rank,
# the rest drawn from the pipeline's generator, reset before each call)
ENTRY22 = {
    "text2img": ("generate_text2img", "text2img", dict(prompt=PROMPT, **_C22)),
    "text2img dpmpp": ("generate_text2img", "text2img",
                       dict(prompt=PROMPT, sampler="dpmpp", **_C22)),
    "img2img": ("generate_img2img", "text2img",
                dict(prompt=PROMPT, image=_image(30), strength=0.7, **_C22)),
    "inpainting": ("generate_inpainting", "inpainting",
                   dict(prompt=PROMPT, pil_img=_image(31), img_mask=_MASK, **_C22)),
    "controlnet hint": ("generate_controlnet", "controlnet",
                        dict(prompt=PROMPT, hint=np.random.RandomState(33).rand(H, H, 3)
                             .astype(np.float32), **_C22)),
    "mix_images": ("mix_images", "text2img",
                   dict(images_texts=[PROMPT, _image(32)], weights=[0.6, 0.4], **_C22)),
    "hires": ("generate_text2img_hires", "text2img",
              dict(prompt=PROMPT, low_scale=0.5, strength=0.5,
                   **dict(_C22, h=2 * H, w=2 * H))),
    "turbo": ("generate_text2img", "text2img",
              dict(prompt=PROMPT, turbo_interval=2, **_C22)),
    "decode_latents": ("decode_latents", "text2img",
                       dict(latents=seeded_noise(34, 2, 16, 8, 4))),
}


# hires on a UNet of four levels: its 256² stage shards 4-way (32 latent
# rows), while its 128² first stage (16 rows) cannot keep equal even shards
# at every level and runs whole on every rank, so that its 8-bit images
# are the unsharded run's bit for bit
HIRES22 = dict(TINY, unet=dict(WIDE, block_out_channels=(64, 64, 64, 64)))


@pytest.mark.parametrize("case", list(ENTRY22))
def test_entry_point22_sp_matches_unsharded(pool, case):
    entry, task, kw = ENTRY22[case]
    args = ("2.2", task, HIRES22 if case == "hires" else TINY, entry, kw)
    whole = pool.run(ranks.pipeline, 0, *args, seed=5, inject=6)[0]
    got = pool.run(ranks.pipeline, 4, *args, seed=5, inject=6)[0]
    assert np.std(whole) > 1e-3, case
    assert_close(got, whole, SP_TOL, f"2.2 {case} sp4 vs unsharded")


@pytest.fixture(scope="module")
def pipes22():
    return parity_pipelines22(head_channels=64)


def test_decode_loop22_sp_matches_jax(pool, pipes22, monkeypatch):
    """The text2img decoder (ddpm, 4 steps, CFG 4) row-sharded 4-way
    against JAX's unsharded ``_decode_loop`` with the same draws."""
    jp, _, params = pipes22
    capture_jax_floats22(monkeypatch)
    embeds = seeded_noise(60, 2, 32)  # [negative; positive]
    x_T, nseq = seeded_noise(61, 1, 16, 16, 4), seeded_noise(62, 4, 1, 16, 16, 4)
    want = jp._decode_loop(jnp.asarray(embeds), 1, 4, 4.0, H, H, x_T=jnp.asarray(x_T),
                           noise_seq=nseq)
    got = pool.run(ranks.decode_loop22, 4, TINY, params, embeds, x_T, nseq, 4, 4.0,
                   H, H)[0]
    assert_images(got, want, "2.2 text2img decoder sp4 vs JAX")


# --- the 2.0 entry points ---------------------------------------------------------

CFG20 = small_config20(64)
_C20 = dict(num_steps=4, h=H, w=H, guidance_scale=5)


def _nseq20(seed, n, size=H):
    return seeded_noise(seed, n, 1, size // 8, size // 8, 4)


ENTRY20 = {
    "text2img ddim eta": ("generate_text2img", "text2img",
                          dict(prompt=PROMPT, noise=seeded_noise(70, 1, 16, 16, 4),
                               noise_seq=_nseq20(71, len(ddim_ladder(4))), **_C20)),
    "text2img p_sampler": ("generate_text2img", "text2img",
                           dict(prompt=PROMPT, sampler="p_sampler",
                                noise_seq=_nseq20(72, 4), **_C20)),
    "text2img plms": ("generate_text2img", "text2img",
                      dict(prompt=PROMPT, sampler="plms_sampler", **_C20)),
    "img2img": ("generate_img2img", "text2img",
                dict(prompt=PROMPT, pil_img=_image(73), strength=0.7, num_steps=4,
                     noise_seq=_nseq20(74, len(ddim_ladder(4, init_step=300)), 512))),
    "inpainting p_sampler": ("generate_inpainting", "inpainting",
                             dict(prompt=PROMPT, pil_img=_image(75), sampler="p_sampler",
                                  img_mask=np.pad(np.zeros((256, 256), np.float32), 128,
                                                  constant_values=1.0),
                                  num_steps=2, noise_seq=_nseq20(76, 2, 512))),
    "decode_latents": ("decode_latents", "text2img",
                       dict(latents=seeded_noise(77, 1, 16, 8, 4))),
}


@pytest.mark.parametrize("case", list(ENTRY20))
def test_entry_point20_sp_matches_unsharded(pool, case):
    entry, task, kw = ENTRY20[case]
    args = ("2.0", task, CFG20, entry, kw)
    whole = pool.run(ranks.pipeline, 0, *args, seed=8)[0]
    got = pool.run(ranks.pipeline, 4, *args, seed=8)[0]
    assert np.std(whole) > 1e-3, case
    assert_close(got, whole, SP_TOL, f"2.0 {case} sp4 vs unsharded")


@pytest.fixture(scope="module")
def pipes20():
    return parity_pipelines20(head_channels=64)


def test_text2img20_sp_matches_jax(pool, pipes20, monkeypatch):
    """DDIM at eta 0.05 with its per-step noise injected, sharded 4-way,
    against JAX's unsharded ``generate_text2img``."""
    jp, _, params = pipes20
    capture_jax_floats20(monkeypatch)
    kw = ENTRY20["text2img ddim eta"][2]
    want = jp.generate_text2img(**kw)
    got = pool.run(ranks.pipeline, 4, "2.0", "text2img", CFG20, "generate_text2img",
                   kw, params=params)[0]
    assert_images(got, want, "2.0 text2img sp4 vs JAX")


@pytest.mark.parametrize("version", ["2.2", "2.0"])
def test_sp_rejects_bad_rows(pipes22, pipes20, version):
    """A latent height that does not keep equal even shards at every UNet
    level raises with ``check_sp_rows``'s message (the check needs only
    the mesh's size)."""
    mesh16 = types.SimpleNamespace(shape={"sp": 16})
    pipe, kw = (pipes22[1], _C22) if version == "2.2" else (pipes20[1], _C20)
    with pytest.raises(ValueError, match="sp_axis"):
        pipe.generate_text2img(PROMPT, sp_mesh=mesh16, **kw)


# --- make_sp_lora_train_fn ----------------------------------------------------------

B_LORA, LAT = 2, 16


def _jax_draws(key, b_local):
    """The t [B] and noise of one JAX sharded LoRA step over the whole
    batch: JAX folds the data index into the step's key for t, and the sp
    index too for each shard's noise rows (``train_lora.py:79-86``)."""
    d, s = SHAPE
    ts, noise, hl = [], np.zeros((B_LORA, LAT, LAT, 4), np.float32), LAT // s
    for di in range(d):
        rng_t, rng_n = jax.random.split(jax.random.fold_in(key, di))
        ts.append(np.asarray(jax.random.randint(rng_t, (b_local,), 0, 1000)))
        for si in range(s):
            nz = jax.random.normal(jax.random.fold_in(rng_n, si), (b_local, hl, LAT, 4))
            noise[di * b_local:(di + 1) * b_local, si * hl:(si + 1) * hl] = np.asarray(nz)
    return np.concatenate(ts), noise


def _jax_sp_lora():
    """Two ``optax.sgd`` steps of JAX's make_sp_lora_train_fn on a (data 2,
    sp 2) mesh of 4 virtual devices, and each step's draws."""
    ju = junet22.UNet22(**WIDE)
    x0 = 0.5 * seeded_noise(80, B_LORA, LAT, LAT, 4)
    cond = seeded_noise(81, B_LORA, WIDE["encoder_hid_dim"])
    shapes = jax.eval_shape(ju.init, jax.random.PRNGKey(0), x0, np.zeros((B_LORA,)),
                            cond)
    params = numpy_params(shapes["params"], 82)
    loras = jlora.init_lora(params, jax.random.PRNGKey(1), rank=2)
    rng = np.random.RandomState(83)
    for f in loras.values():  # non-zero up, so that down has a gradient
        f["up"] = jnp.asarray(0.05 * rng.randn(*f["up"].shape).astype(np.float32))
    start = {p: {k: np.asarray(v) for k, v in f.items()} for p, f in loras.items()}
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(SHAPE), ("data", "sp"))
    tx = optax.sgd(LR)
    fn = jtrain.make_sp_lora_train_fn(jtrain.unet22_eps_fn(ju, sp_axis="sp"), params,
                                      ACP, tx, mesh)
    state = jtrain.init_lora_train_state(loras, tx)
    draws, losses = [], []
    for i in range(2):
        key = jax.random.PRNGKey(90 + i)
        draws.append(_jax_draws(key, B_LORA // SHAPE[0]))
        state, m = fn(state, jnp.asarray(x0), jnp.asarray(cond), key)
        losses.append(float(m["loss"]))
    final = {p: {k: np.asarray(v) for k, v in f.items()} for p, f in state.loras.items()}
    return dict(params=params, loras=start, final=final, x0=x0, cond=cond, draws=draws,
                losses=losses)


@pytest.fixture(scope="module")
def jax_sp_lora(jax_lora_started):
    return jax_lora_started.result()


@pytest.mark.parametrize("sharded", [False, True], ids=["whole batch", "each rank's shard"])
def test_sp_lora_two_steps_match_jax(pool, jax_sp_lora, sharded):
    j = jax_sp_lora
    ts, noises = zip(*j["draws"])
    res = pool.run(ranks.sp_lora_steps, SHAPE, WIDE, j["params"], j["loras"], ACP,
                   j["x0"], j["cond"], list(ts), list(noises), LR, sharded=sharded)
    r = res[0]
    assert r["step"] == 2 and all(x["same_base"] for x in res)
    for other in res[1:]:
        for name, a in r["factors"].items():
            np.testing.assert_array_equal(other["factors"][name], a, err_msg=name)
    np.testing.assert_allclose(r["losses"], j["losses"], rtol=LORA_TOL)
    want = flatten_loras(lora_from_jax(j["final"]))
    start = flatten_loras(lora_from_jax(j["loras"]))
    assert set(want) == set(r["factors"])
    moved = 0
    for name, w in want.items():
        assert_close(r["factors"][name], w, LORA_TOL, f"factor {name}")
        moved += int(not np.array_equal(r["factors"][name], start[name].numpy()))
    assert moved == len(want)
