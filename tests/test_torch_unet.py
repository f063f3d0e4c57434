"""The port's UNet modules (``kandinsky2_tpu_torch/models/unet.py``) against
the JAX package's, with every parameter drawn from a numpy seed and loaded
into both through the bridge, in fp32 at 1e-4.  The JAX side runs under
``jax.jit``: op-by-op it takes seconds on the CPU."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kandinsky2_tpu import configs as jcfg
from kandinsky2_tpu.models import unet as junet
from kandinsky2_tpu_torch import configs as tcfg
from kandinsky2_tpu_torch.models import unet as tunet
from kandinsky2_tpu_torch.weights.from_jax import load_jax_params
from test_torch_common import MODULE_TOL, assert_close, numpy_params, small_config

T = torch.from_numpy


@pytest.mark.parametrize("cin,cout,up,down", [
    (64, 128, False, False), (64, 64, True, False), (64, 64, False, True),
])
def test_resblock(cin, cout, up, down):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, cin).astype(np.float32)
    emb = rng.randn(2, 256).astype(np.float32)
    jm = junet.ResBlock(cin, cout, up=up, down=down)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, emb), 1)
    want = jax.jit(jm.apply)(params, x, emb)
    tm = load_jax_params(tunet.ResBlock(cin, cout, 256, up=up, down=down),
                         params["params"])
    with torch.no_grad():
        got = tm(T(x), T(emb))
    assert_close(got, want, MODULE_TOL, "ResBlock")


def test_attention_block_with_encoder_tokens():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 6, 64).astype(np.float32)
    enc = rng.randn(2, 5, 48).astype(np.float32)
    jm = junet.AttentionBlock(64, 2, use_encoder_kv=True)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, enc), 3)
    want = jax.jit(jm.apply)(params, x, enc)
    tm = load_jax_params(tunet.AttentionBlock(64, 2, encoder_channels=48),
                         params["params"])
    with torch.no_grad():
        got = tm(T(x), T(enc))
    assert_close(got, want, MODULE_TOL, "AttentionBlock")


def test_text2im_unet21_encode_and_denoise():
    mc = small_config()["model_config"]
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    ts = np.array([999.0, 421.0], np.float32)
    full = rng.randn(2, 6, mc["text_encoder_in_dim1"]).astype(np.float32)
    pooled = rng.randn(2, mc["text_encoder_in_dim2"]).astype(np.float32)
    image = rng.randn(2, mc["image_encoder_in_dim"]).astype(np.float32)
    jm = jcfg.create_model(**mc, dtype=jnp.float32)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, ts, full_emb=full,
                                  pooled_emb=pooled, image_emb=image), 5)
    xf_proj, xf_out = jax.jit(partial(
        jm.apply, method=type(jm).encode_conditioning))(params, full, pooled, image)
    want = jax.jit(partial(jm.apply, method=type(jm).denoise))(
        params, x, ts, xf_proj, xf_out)

    tm = load_jax_params(tcfg.create_model(**mc, dtype=torch.float32),
                         params["params"])
    with torch.no_grad():
        t_proj, t_out = tm.encode_conditioning(T(full), T(pooled), T(image))
        got = tm.denoise(T(x), T(ts), t_proj, t_out)
    assert_close(t_proj, xf_proj, MODULE_TOL, "xf_proj")
    assert_close(t_out, xf_out, MODULE_TOL, "xf_out")
    assert_close(got, want, MODULE_TOL, "denoise")
    assert np.abs(np.asarray(want)).max() > 1e-2  # a live output head


def _unet21_pair(pooling_type, inpainting, seed):
    """The JAX and port 2.1 UNets at ``small_config`` with ``pooling_type``
    (and the inpainting variant), one parameter draw loaded into both."""
    mc = dict(small_config()["model_config"], pooling_type=pooling_type)
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    ts = np.array([999.0, 421.0], np.float32)
    full = rng.randn(2, 6, mc["text_encoder_in_dim1"]).astype(np.float32)
    pooled = rng.randn(2, mc["text_encoder_in_dim2"]).astype(np.float32)
    image = rng.randn(2, mc["image_encoder_in_dim"]).astype(np.float32)
    jm = jcfg.create_model(**mc, inpainting=inpainting, dtype=jnp.float32)
    params = numpy_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), x, ts,
        full_emb=full, pooled_emb=pooled, image_emb=image), seed + 1)
    tm = load_jax_params(tcfg.create_model(**mc, inpainting=inpainting,
                                           dtype=torch.float32), params["params"])
    return jm, params, tm, (x, ts, full, pooled, image)


@pytest.mark.parametrize("pooling_type,inpainting", [
    ("from_model", True), ("attention", False), ("attention", True),
])
def test_text2im_unet21_pooling_types(pooling_type, inpainting):
    """Attention pooling (``proj_n`` an ``AttentionPooling`` of the XLM-R
    tokens) and the inpainting variant against JAX at 1e-4."""
    jm, params, tm, (x, ts, full, pooled, image) = _unet21_pair(
        pooling_type, inpainting, 6)
    assert isinstance(tm.proj_n, tunet.AttentionPooling) == (pooling_type != "from_model")
    kw = {}
    if inpainting:
        rng = np.random.RandomState(8)
        kw = dict(inpaint_image=rng.randn(2, 8, 8, 4).astype(np.float32),
                  inpaint_mask=(rng.rand(2, 8, 8, 1) > 0.5).astype(np.float32))
    want = jax.jit(jm.apply)(params, x, ts, full_emb=full, pooled_emb=pooled,
                             image_emb=image, **kw)
    with torch.no_grad():
        got = tm(T(x), T(ts), T(full), T(pooled), T(image),
                 **{k: T(v) for k, v in kw.items()})
    assert_close(got, want, MODULE_TOL, f"{pooling_type} inpainting={inpainting}")


@pytest.mark.parametrize("split", [1, 3])
def test_run_torso_cached_split(split):
    """A non-default DeepCache ``split``: the cache spec and one refreshing
    and one cached torso step against JAX's, within 1e-5."""
    jm, params, tm, (x, ts, full, pooled, image) = _unet21_pair("from_model", False, 10)
    default = tm.num_res_blocks + 1
    assert split != default
    spec = junet.deep_cache_spec(jm, split)
    assert tunet.deep_cache_spec(tm, split) == spec
    assert tunet.deep_cache_spec(tm) == junet.deep_cache_spec(jm) != spec
    with pytest.raises(ValueError):
        tunet.deep_cache_spec(tm, len(tm.input_blocks))
    rng = np.random.RandomState(11)
    emb = rng.randn(2, 4 * tm.model_channels).astype(np.float32)
    enc = rng.randn(2, 5, tm.model_dim).astype(np.float32)
    cache0 = np.zeros((2, 8 // spec[0], 8 // spec[0], spec[1]), np.float32)
    run = jax.jit(partial(jm.apply, method=type(jm).run_torso_cached),
                  static_argnums=(4, 6))
    want, want_cache = run(params, x, emb, cache0, True, enc, split)
    x2 = x + 0.1 * rng.randn(*x.shape).astype(np.float32)
    want2, _ = run(params, x2, emb, want_cache, False, enc, split)
    with torch.no_grad():
        got, got_cache = tm.run_torso_cached(T(x), T(emb), None, True, T(enc), split)
        got2, _ = tm.run_torso_cached(T(x2), T(emb), got_cache, False, T(enc), split)
    assert tuple(got_cache.shape) == cache0.shape
    assert_close(got_cache, want_cache, 1e-5, "cache")
    assert_close(got, want, 1e-5, "refresh step")
    assert_close(got2, want2, 1e-5, "cached step")
