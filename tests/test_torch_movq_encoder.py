"""The port's MoVQ encoder half (``Encoder`` with the asymmetric-pad
``Downsample``, ``quant_conv``, ``VectorQuantizer``) and the training
path's frozen-encoder helpers against the JAX package's, every parameter
drawn from a numpy seed and loaded into both through the bridge, in fp32
at 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kandinsky2_tpu.models import movq as jmovq
from kandinsky2_tpu.pipelines.kandinsky2_1 import clip_preprocess as jclip_preprocess
from kandinsky2_tpu_torch.models import movq as tmovq
from kandinsky2_tpu_torch.pipelines.kandinsky2_1 import clip_preprocess
from kandinsky2_tpu_torch.weights.from_jax import load_jax_params
from test_torch_common import MODULE_TOL, assert_close, numpy_params, small_config

T = torch.from_numpy


def _movq_pair(seed):
    dd = small_config()["image_enc_params"]["params"]["ddconfig"]
    kw = dict(ch=dd["ch"], ch_mult=tuple(dd["ch_mult"]),
              num_res_blocks=dd["num_res_blocks"],
              attn_resolutions=tuple(dd["attn_resolutions"]),
              resolution=dd["resolution"])
    jm = jmovq.MOVQ(n_embed=64, **kw)
    params = numpy_params(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), seed)
    tm = load_jax_params(tmovq.MOVQ(n_embed=64, **kw), params["params"])
    return jm, params, tm


def test_movq_encode():
    """Encoder at 64² (attention at the 8² level and in the middle, three
    asymmetric-pad downsamples) and quant_conv, NHWC."""
    jm, params, tm = _movq_pair(0)
    x = np.tanh(np.random.RandomState(1).randn(2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jm.apply(p, x, method=jm.encode))(params, x)
    with torch.no_grad():
        got = tm.encode(T(x))
    assert got.shape == (2, 8, 8, 4)
    assert_close(got, want, MODULE_TOL, "MOVQ.encode")


def test_downsample_pads_bottom_and_right():
    rng = np.random.RandomState(2)
    x = rng.randn(1, 6, 6, 8).astype(np.float32)
    jm = jmovq.Downsample(8)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 3)
    want = jm.apply(params, x)
    tm = load_jax_params(tmovq.Downsample(8), params["params"])
    with torch.no_grad():
        got = tm(T(x))
    assert got.shape == (1, 3, 3, 8)
    assert_close(got, want, MODULE_TOL, "Downsample")


def test_vector_quantizer():
    """Nearest-codebook indices equal, z_q within 1e-4, and the
    straight-through gradient is the identity."""
    jm, params, tm = _movq_pair(4)
    z = np.random.RandomState(5).randn(2, 4, 4, 4).astype(np.float32) * 0.02
    want_zq, want_idx = jm.apply(params, jnp.asarray(z),
                                 method=lambda m, z: m.quantize(z))
    tz = T(z).requires_grad_()
    got_zq, got_idx = tm.quantize(tz)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert_close(got_zq, want_zq, MODULE_TOL, "z_q")
    got_zq.sum().backward()
    assert torch.equal(tz.grad, torch.ones_like(tz))


def test_clip_preprocess_matches_jax():
    from PIL import Image

    arr = np.random.RandomState(6).randint(0, 256, (50, 70, 3), np.uint8)
    img = Image.fromarray(arr)
    np.testing.assert_array_equal(clip_preprocess(img, 28), jclip_preprocess(img, 28))
