"""The port's 2.2 prior towers against the JAX package's on the CPU in
fp32, with the same numpy-seeded parameters through the bridge, at the
per-module tolerance: ``PriorTransformer22`` (with a padded text mask and
the embedding order of the config, and one reordered), ``HFCLIPText``
(causal mask, pooling at the first end-of-text token, bias-free fp32
projection) and ``HFCLIPVision`` (ViT layout, exact GELU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kandinsky2_tpu.models import prior22 as jprior22
from kandinsky2_tpu.models import text_encoders as jtext
from kandinsky2_tpu_torch.models import prior22 as tprior22
from kandinsky2_tpu_torch.models import text_encoders as ttext
from kandinsky2_tpu_torch.weights.from_jax import load_jax_params
from test_torch_common import MODULE_TOL, assert_close, numpy_params

# test_pipeline22.py's TINY towers
PRIOR = dict(num_attention_heads=4, attention_head_dim=16, num_layers=2,
             embedding_dim=32, num_embeddings=8)
TEXT = dict(vocab_size=64, context_length=8, hidden=32, layers=2, heads=4,
            intermediate=64, projection_dim=32, eot_token_id=63)
VISION = dict(image_size=28, patch_size=14, hidden=32, layers=2, heads=4,
              intermediate=64, projection_dim=32)


def _load(jmod, tmod, args, seed):
    shapes = jax.eval_shape(lambda k: jmod.init(k, *args), jax.random.PRNGKey(0))
    params = numpy_params(shapes["params"], seed)
    load_jax_params(tmod, params)
    return params


@pytest.mark.parametrize("order", [None, ("prd", "x", "time", "proj", "text")])
def test_prior_transformer22_matches_jax(order):
    kw = dict(PRIOR) if order is None else dict(PRIOR, embedding_order=order)
    jm, tm = jprior22.PriorTransformer22(**kw), tprior22.PriorTransformer22(**kw)
    rng = np.random.RandomState(2)
    D, L = PRIOR["embedding_dim"], PRIOR["num_embeddings"]
    mask = np.ones((2, L), bool)
    mask[1, 5:] = False
    args = (rng.randn(2, D).astype(np.float32), np.array([999.0, 40.0], np.float32),
            rng.randn(2, D).astype(np.float32), rng.randn(2, L, D).astype(np.float32),
            mask)
    params = _load(jm, tm, [jnp.asarray(a) for a in args], 5)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, *args)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in args))
        post = tm.post_process(got)
    assert_close(got, want, MODULE_TOL, "PriorTransformer22")
    want_post = jm.apply({"params": params}, want, method=jm.post_process)
    assert_close(post, want_post, MODULE_TOL, "post_process")


def test_hf_clip_text_matches_jax():
    jm, tm = jprior22.HFCLIPText(**TEXT), tprior22.HFCLIPText(**TEXT)
    tokens = np.array([[5, 9, 12, 63, 0, 0, 0, 0],   # eot at 3
                       [7, 63, 8, 63, 0, 0, 0, 0]],  # the first eot pools
                      np.int32)
    params = _load(jm, tm, [jnp.asarray(tokens)], 6)
    want = jax.jit(lambda p, t: jm.apply({"params": p}, t))(params, tokens)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens).long())
    for name, g, w in zip(("hidden", "projection"), got, want):
        assert g.dtype == torch.float32
        assert_close(g, w, MODULE_TOL, name)


def test_hf_clip_vision_matches_jax():
    jm, tm = jtext.HFCLIPVision(**VISION), ttext.HFCLIPVision(**VISION)
    images = np.random.RandomState(3).randn(2, 28, 28, 3).astype(np.float32)
    params = _load(jm, tm, [jnp.asarray(images)], 7)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, images)
    with torch.no_grad():
        got = tm(torch.from_numpy(images))
    assert got.dtype == torch.float32
    assert_close(got, want, MODULE_TOL, "HFCLIPVision")


def test_exact_gelu_matches_jax():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    assert_close(ttext.exact_gelu(torch.from_numpy(x)), jtext.exact_gelu(jnp.asarray(x)),
                 1e-6, "exact_gelu")
