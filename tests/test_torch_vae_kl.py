"""The port's KL-VAE (``AutoencoderKL``, 2.0's image codec) and plain VQ
codec (``VQModelInterface``) against the JAX package's, at the tiny 2.0
codec's shape (width 32, ch_mult 1, 1, 1, 2, no attention but the mid
block's), every parameter drawn from a numpy seed and loaded into both
through the bridge, in fp32 at 1e-4: ``encode`` (the posterior's mean and
clipped log-variance), ``sample_posterior`` with the same noise,
``decode`` through the plain-GroupNorm decoder, and the forward; the VQ
codec's encode and decode with and without the codebook."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kandinsky2_tpu.models import movq as jmovq
from kandinsky2_tpu_torch.models import movq as tmovq
from kandinsky2_tpu_torch.weights.from_jax import load_jax_params
from test_torch_common import MODULE_TOL, assert_close, numpy_params

T = torch.from_numpy
KW = dict(ch=32, ch_mult=(1, 1, 1, 2), num_res_blocks=1, attn_resolutions=(),
          resolution=64)


@pytest.fixture(scope="module")
def kl():
    jm = jmovq.AutoencoderKL(**KW)
    x = np.tanh(np.random.RandomState(1).randn(2, 64, 48, 3)).astype(np.float32)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 7)
    # a log-variance past the clip at both ends: the 1x1 quant_conv's bias
    params["params"]["quant_conv"]["bias"] = np.array(
        [0, 0, 0, 0, 40.0, -40.0, 0.5, -0.5], np.float32)
    tm = load_jax_params(tmovq.AutoencoderKL(**KW), params["params"])
    return jm, tm, params, x


def test_autoencoder_kl_encode(kl):
    jm, tm, params, x = kl
    mean, logvar = jax.jit(lambda p, x: jm.apply(p, x, method=jm.encode))(params, x)
    with torch.no_grad():
        t_mean, t_logvar = tm.encode(T(x))
    assert t_mean.shape == (2, 8, 6, 4)
    assert_close(t_mean, mean, MODULE_TOL, "AutoencoderKL.encode mean")
    assert_close(t_logvar, logvar, MODULE_TOL, "AutoencoderKL.encode logvar")
    lv = t_logvar.numpy()
    assert lv.max() == 20.0 and lv.min() == -30.0  # clipped


def test_autoencoder_kl_sample_posterior(kl):
    """The JAX module draws its own noise: held against its mean and
    log-variance with the port's noise."""
    jm, tm, params, x = kl
    mean, logvar = jax.jit(lambda p, x: jm.apply(p, x, method=jm.encode))(params, x)
    n = np.random.RandomState(2).randn(2, 8, 6, 4).astype(np.float32)
    with torch.no_grad():
        got = tm.sample_posterior(T(x), T(n))
    assert_close(got, np.asarray(mean) + np.exp(0.5 * np.asarray(logvar)) * n,
                 MODULE_TOL, "AutoencoderKL.sample_posterior")


def test_autoencoder_kl_decode_and_forward(kl):
    jm, tm, params, x = kl
    z = np.random.RandomState(3).randn(1, 8, 8, 4).astype(np.float32)
    want = jax.jit(lambda p, z: jm.apply(p, z, method=jm.decode))(params, z)
    want_fwd = jax.jit(jm.apply)(params, x)
    with torch.no_grad():
        got = tm.decode(T(z))
        fwd = tm(T(x))
    assert got.shape == (1, 64, 64, 3)
    assert_close(got, want, MODULE_TOL, "AutoencoderKL.decode")
    assert_close(fwd, want_fwd, MODULE_TOL, "AutoencoderKL forward")
    # the plain decoder: a GroupNorm at every norm, no SpatialNorm
    assert not any(isinstance(m, tmovq.SpatialNorm) for m in tm.modules())


@pytest.mark.parametrize("force_not_quantize", [False, True])
def test_vq_model_interface(force_not_quantize):
    kw = dict(KW, attn_resolutions=(16,), n_embed=32)
    jm = jmovq.VQModelInterface(**kw)
    x = np.tanh(np.random.RandomState(4).randn(1, 64, 64, 3)).astype(np.float32)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 8)
    h = jax.jit(lambda p, x: jm.apply(p, x, method=jm.encode))(params, x)
    want = jax.jit(lambda p, h: jm.apply(
        p, h, force_not_quantize, method=jm.decode))(params, h)
    tm = load_jax_params(tmovq.VQModelInterface(**kw), params["params"])
    with torch.no_grad():
        t_h = tm.encode(T(x))
        got = tm.decode(t_h, force_not_quantize)
    assert_close(t_h, h, MODULE_TOL, "VQModelInterface.encode")
    assert_close(got, want, MODULE_TOL, "VQModelInterface.decode")
