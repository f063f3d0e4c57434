"""The port's bits-per-dim evaluation (``prior_bpd``, ``calc_bpd_loop`` of
``kandinsky2_tpu_torch/diffusion/gaussian.py``) and its super-resolution
UNets (``models/unet.py``) against the JAX package's, in fp32 on the CPU:
the cases of ``tests/test_bpd_superres.py``, with the JAX loop's noise
(one ``fold_in`` of the key per timestep) handed to the port, and each
SuperRes UNet's forward at a tiny width on numpy-seeded parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kandinsky2_tpu.diffusion import MeanType as JMean
from kandinsky2_tpu.diffusion import VarType as JVar
from kandinsky2_tpu.diffusion import make_schedule as jmake
from kandinsky2_tpu.diffusion.gaussian import calc_bpd_loop as jcalc
from kandinsky2_tpu.diffusion.gaussian import prior_bpd as jprior
from kandinsky2_tpu.models import layers as jlayers
from kandinsky2_tpu.models import unet as junet
from kandinsky2_tpu_torch.diffusion import gaussian as tg
from kandinsky2_tpu_torch.models import layers as tlayers
from kandinsky2_tpu_torch.models import unet as tunet
from kandinsky2_tpu_torch.weights.from_jax import load_jax_params
from test_torch_common import MODULE_TOL, assert_close, numpy_params

T = torch.from_numpy
SCHED = dict(steps=1000, noise_schedule="linear", rescale_timesteps=True)


@pytest.mark.parametrize("respacing", ["10", ""])
def test_prior_bpd_matches_jax(respacing):
    x0 = np.random.RandomState(0).randn(2, 4, 8, 8).astype(np.float32)
    want = jprior(jmake(**SCHED, timestep_respacing=respacing), jnp.asarray(x0))
    got = tg.prior_bpd(tg.make_schedule(**SCHED, timestep_respacing=respacing), T(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("channel_axis", [1, -1])
def test_calc_bpd_loop_matches_jax(channel_axis):
    """Every returned term over a 6-step respaced schedule, the model an
    affine map of x_t with a learned-range variance, NCHW and NHWC."""
    steps = 6
    rng = np.random.RandomState(1)
    shape = (2, 4, 8, 8) if channel_axis == 1 else (2, 8, 8, 4)
    x0 = np.tanh(rng.randn(*shape)).astype(np.float32)
    W = (0.1 * rng.randn(*shape[1:])).astype(np.float32)
    key = jax.random.PRNGKey(3)

    def model(lib, cat):
        return lambda x, t: cat([0.9 * x + lib.asarray(W), 0.2 * lib.tanh(x)],
                                channel_axis)

    jsched = jmake(**SCHED, timestep_respacing=str(steps))
    want = jcalc(jsched, model(jnp, lambda xs, a: jnp.concatenate(xs, axis=a)),
                 jnp.asarray(x0), key, mean_type=JMean.EPSILON,
                 var_type=JVar.LEARNED_RANGE, channel_axis=channel_axis)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, t), shape,
                                                   jnp.float32)) for t in range(steps)])
    tsched = tg.make_schedule(**SCHED, timestep_respacing=str(steps))
    tmodel = model(torch, lambda xs, a: torch.cat(xs, dim=a))
    got = tg.calc_bpd_loop(
        tsched, lambda x, t: tmodel(x, t), T(x0), noise=T(noise),
        mean_type=tg.MeanType.EPSILON, var_type=tg.VarType.LEARNED_RANGE,
        channel_axis=channel_axis)
    assert got["vb"].shape == (2, steps) and got["mse"].shape == (2, steps)
    for k in ("total_bpd", "prior_bpd", "vb", "xstart_mse", "mse"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["total_bpd"].numpy(),
                               got["vb"].numpy().sum(1) + got["prior_bpd"].numpy(),
                               rtol=1e-5)


def test_calc_bpd_loop_draws_from_a_generator():
    """Without ``noise`` the loop draws from the generator: the same seed
    gives the same terms, finite."""
    sched = tg.make_schedule(**SCHED, timestep_respacing="4")
    x0 = torch.tanh(torch.randn(2, 6, 6, 4, generator=torch.Generator().manual_seed(0)))
    model = lambda x, t: torch.cat([0.5 * x, torch.zeros_like(x)], dim=-1)
    a, b = (tg.calc_bpd_loop(sched, model, x0, torch.Generator().manual_seed(9))
            for _ in range(2))
    assert torch.isfinite(a["total_bpd"]).all()
    assert torch.equal(a["total_bpd"], b["total_bpd"])


@pytest.mark.parametrize("size", [(16, 16), (12, 20)])
def test_resize_bilinear_upsampling_matches_jax(size):
    x = np.random.RandomState(2).randn(2, 8, 10, 3).astype(np.float32)
    want = jlayers.resize_bilinear(jnp.asarray(x), size)
    got = tlayers.resize_bilinear(T(x), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_resize_bilinear_shrinking_departs_from_jax():
    """A departure: ``jax.image.resize`` antialiases when it shrinks and the
    port's ``F.interpolate`` does not, so a 2x shrink differs (no
    super-resolution UNet shrinks)."""
    x = np.random.RandomState(3).randn(1, 16, 16, 2).astype(np.float32)
    want = np.asarray(jlayers.resize_bilinear(jnp.asarray(x), (8, 8)))
    got = tlayers.resize_bilinear(T(x), (8, 8)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() > 1e-2


COMMON = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
              attention_resolutions=(2,), num_head_channels=16, out_channels=8)
TEXT = dict(model_dim=32, image_encoder_in_dim=24, text_encoder_in_dim1=20,
            text_encoder_in_dim2=32, num_image_embs=2)


@pytest.mark.parametrize("kind", ["sr", "sr_inpaint", "sr_text"])
def test_superres_unets_match_jax(kind):
    """``SuperResUNetModel`` (2C inputs), ``SuperResInpaintUNetModel``
    (3C + 1) and ``SuperResText2ImUNet21`` (2C, text and image
    conditioning) at the JAX test's tiny width, 16² from an 8² low-res
    image, on numpy-seeded parameters."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    low = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    kw = {"low_res": low}
    if kind == "sr":
        jm, tm = junet.SuperResUNetModel(in_channels=8, **COMMON), \
            tunet.SuperResUNetModel(in_channels=8, **COMMON)
    elif kind == "sr_inpaint":
        jm, tm = junet.SuperResInpaintUNetModel(in_channels=13, **COMMON), \
            tunet.SuperResInpaintUNetModel(in_channels=13, **COMMON)
        kw.update(inpaint_image=rng.randn(2, 16, 16, 4).astype(np.float32),
                  inpaint_mask=(rng.rand(2, 16, 16, 1) > 0.5).astype(np.float32))
    else:
        jm = junet.SuperResText2ImUNet21(in_channels=8, pooling_type="from_model",
                                         use_encoder_kv=True, **TEXT, **COMMON)
        tm = tunet.SuperResText2ImUNet21(in_channels=8, **TEXT, **COMMON)
        kw.update(full_emb=rng.randn(2, 5, 20).astype(np.float32),
                  pooled_emb=rng.randn(2, 32).astype(np.float32),
                  image_emb=rng.randn(2, 24).astype(np.float32))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(t), **{k: jnp.asarray(v) for k, v in kw.items()})
    params = numpy_params(shapes["params"], 5)
    want = jax.jit(lambda p, x, t, kw: jm.apply({"params": p}, x, t, **kw))(
        params, x, t, kw)
    load_jax_params(tm, params)
    with torch.no_grad():
        got = tm(T(x), T(t), **{k: T(v) for k, v in kw.items()})
    assert got.shape == (2, 16, 16, 8)
    assert_close(got, want, MODULE_TOL, kind)
