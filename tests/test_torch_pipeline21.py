"""The port's diffusion math and its 2.1 text2img pipeline against the JAX
package: schedule tables and sampler loops on a toy model at 1e-4, and the
seeded end-to-end float image at the ``bench.py --small`` configuration at
3e-3, with the same parameters (numpy seed, through the bridge) and the same
injected ``noise``, ``prior_noise`` and ``prior_noise_seq``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kandinsky2_tpu.pipelines.kandinsky2_1 as jpipe_mod
from kandinsky2_tpu import diffusion as jd
from kandinsky2_tpu_torch import diffusion as td
from kandinsky2_tpu_torch.pipelines import Kandinsky2_1 as TorchK21
from kandinsky2_tpu_torch.host_ops import f32_to_u8_images
from kandinsky2_tpu_torch.utils import stub_tokenizers
from test_torch_common import (
    E2E_TOL,
    MODULE_TOL,
    assert_close,
    numpy_params,
    small_config,
)

T = torch.from_numpy


def test_schedule_and_ddim_tables():
    kw = dict(steps=1000, noise_schedule="cosine", timestep_respacing="25")
    js, ts = jd.make_schedule(**kw), td.make_schedule(**kw)
    for name in ("betas", "alphas_cumprod_prev", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2",
                 "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    t = np.arange(25)
    np.testing.assert_array_equal(ts.model_timesteps(T(t)).numpy(),
                                  np.asarray(js.model_timesteps(jnp.asarray(t))))
    base = jd.make_schedule(steps=1000, linear_start=0.00085, linear_end=0.012)
    jt = jd.make_ddim_tables(np.asarray(base.alphas_cumprod, np.float64), 50)
    tb = td.make_schedule(steps=1000, linear_start=0.00085, linear_end=0.012)
    tt = td.make_ddim_tables(tb.base_alphas_cumprod, 50)
    np.testing.assert_array_equal(tt.timesteps, np.asarray(jt.timesteps))
    for name in ("alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)))


def _toy_model(x, t, w):
    """A smooth model whose output depends on x and t in both frameworks."""
    return (x @ w) * 0.3 + 0.001 * t[:, None]


def test_p_sample_loop_start_x_with_noise_seq():
    rng = np.random.RandomState(0)
    w = rng.randn(6, 6).astype(np.float32) / 3
    x_T = rng.randn(3, 6).astype(np.float32)
    kw = dict(steps=1000, noise_schedule="cosine", timestep_respacing="7")
    nseq = rng.randn(7, 3, 6).astype(np.float32)
    want = jd.p_sample_loop(
        lambda x, t: _toy_model(x, t, jnp.asarray(w)), jd.make_schedule(**kw),
        jnp.asarray(x_T), mean_type=jd.MeanType.START_X,
        var_type=jd.VarType.FIXED_SMALL, clip_denoised=False,
        denoised_fn=lambda v: jnp.clip(v, -10, 10), noise_seq=jnp.asarray(nseq),
    )
    got = td.p_sample_loop(
        lambda x, t: _toy_model(x, t, T(w)), td.make_schedule(**kw), T(x_T),
        mean_type=td.MeanType.START_X, var_type=td.VarType.FIXED_SMALL,
        clip_denoised=False, denoised_fn=lambda v: torch.clamp(v, -10, 10),
        noise_seq=T(nseq),
    )
    assert_close(got, want, MODULE_TOL, "p_sample_loop")


def test_ddim_loop():
    rng = np.random.RandomState(1)
    w = rng.randn(5, 5).astype(np.float32) / 3
    x_T = rng.randn(2, 5).astype(np.float32)
    base = jd.make_schedule(steps=1000, linear_start=0.00085, linear_end=0.012)
    jt = jd.make_ddim_tables(np.asarray(base.alphas_cumprod, np.float64), 25)
    tb = td.make_schedule(steps=1000, linear_start=0.00085, linear_end=0.012)
    want = jd.ddim_loop(lambda x, t: _toy_model(x, t, jnp.asarray(w)), jt,
                        jnp.asarray(x_T))
    got = td.ddim_loop(lambda x, t: _toy_model(x, t, T(w)),
                       td.make_ddim_tables(tb.base_alphas_cumprod, 25), T(x_T))
    assert_close(got, want, MODULE_TOL, "ddim_loop")


def test_text2img_seeded_end_to_end(monkeypatch):
    cfg = small_config()
    tok1, tok2 = stub_tokenizers()
    clip_dim = cfg["prior"]["params"]["model"]["hparams"]["clip_dim"]
    rng = np.random.RandomState(11)
    clip_mean = (0.1 * rng.randn(clip_dim)).astype(np.float32)
    clip_std = (1 + 0.1 * rng.rand(clip_dim)).astype(np.float32)
    jp = jpipe_mod.Kandinsky2_1(config=cfg, tokenizer1=tok1, tokenizer2=tok2,
                                clip_mean=clip_mean, clip_std=clip_std,
                                dtype=jnp.float32)
    params = numpy_params(
        jax.eval_shape(jp.init_random_params, jax.random.PRNGKey(0)), 12)
    # random weights leave the image at |x| ~ 1e2: a small output conv brings
    # it to the [-1, 1] range that the absolute image tolerance is set for
    conv_out = params["movq"]["decoder"]["conv_out"]
    conv_out["kernel"] = conv_out["kernel"] * np.float32(0.01)
    jp.params = jax.tree_util.tree_map(jnp.asarray, params)
    tp = TorchK21(config=cfg, tokenizer1=tok1, tokenizer2=tok2,
                  clip_mean=clip_mean, clip_std=clip_std, dtype=torch.float32,
                  device="cpu")
    tp.load_jax_params(params)

    steps, prior_steps, h = 10, "5", 64
    noise = rng.randn(1, h // 8, h // 8, 4).astype(np.float32)
    prior_noise = rng.randn(1, clip_dim).astype(np.float32)
    prior_noise_seq = rng.randn(5, 1, clip_dim).astype(np.float32)
    kw = dict(num_steps=steps, batch_size=1, guidance_scale=4, h=h, w=h,
              sampler="ddim_sampler", prior_cf_scale=4, prior_steps=prior_steps,
              noise=noise, prior_noise=prior_noise,
              prior_noise_seq=prior_noise_seq)
    monkeypatch.setattr(jpipe_mod, "process_images", np.asarray)
    want = jp.generate_text2img("red sand dunes", **kw)
    got = tp.generate_text2img("red sand dunes", output="float", **kw)
    assert got.shape == (1, h, h, 3)
    assert np.std(got) > 1e-3
    assert np.abs(want).max() < 10
    err = float(np.abs(got - np.asarray(want)).max())
    assert err <= E2E_TOL, f"text2img float image: max abs err {err:.3e}"
    pil = tp.generate_text2img("red sand dunes", **kw)
    np.testing.assert_array_equal(np.asarray(pil[0]), f32_to_u8_images(got)[0])


def test_text2img_rejects_paths_not_ported():
    """What still raises, as in the JAX package: an unknown sampler and an
    unknown ``task_type`` (``ValueError``), before any model runs."""
    tok1, tok2 = stub_tokenizers()
    tp = TorchK21(config=small_config(), tokenizer1=tok1, tokenizer2=tok2,
                  device="meta")
    with pytest.raises(ValueError, match="p_sampler, ddim_sampler"):
        tp.generate_text2img("x", sampler="k_euler_sampler")
    with pytest.raises(ValueError, match="p_sampler, ddim_sampler"):
        tp.generate_img("x", None, sampler="k_euler_sampler")
    with pytest.raises(ValueError, match="Only text2img and inpainting"):
        TorchK21(config=small_config(), tokenizer1=tok1, tokenizer2=tok2,
                 task_type="img2img", device="meta")


def test_random_init_drives_small_path():
    """The random-weight path that chip_smoke.py drives, at a small width on
    the CPU: seeded generator init, bf16 cast, finite non-constant image."""
    tok1, tok2 = stub_tokenizers()
    tp = TorchK21(config=small_config(), tokenizer1=tok1, tokenizer2=tok2,
                  dtype=torch.bfloat16, device="cpu")
    tp.init_random_params(torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.bfloat16 for p in tp.unet.parameters())
    img = tp.generate_text2img("a cat", num_steps=5, guidance_scale=4, h=64, w=64,
                               prior_steps="5", generator=torch.Generator()
                               .manual_seed(1), output="float")
    assert img.shape == (1, 64, 64, 3)
    assert np.isfinite(img).all() and img.std() > 0


def test_entry_points_default_to_the_card():
    """The pipeline, the CLI's ``build_pipeline`` and ``run`` run on the card
    unless the caller asks for the CPU."""
    import inspect

    from kandinsky2_tpu_torch.train import train_2_1_unclip as tcli

    for fn in (TorchK21.__init__, tcli.build_pipeline, tcli.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
