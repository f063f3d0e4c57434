"""The port's MoVQ decoder, diffusion prior and text/image towers against
the JAX package's, every parameter drawn from a numpy seed and loaded into
both through the bridge, in fp32 at 1e-4.  The JAX side runs under
``jax.jit``: op-by-op it takes seconds on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kandinsky2_tpu.models import movq as jmovq
from kandinsky2_tpu.models import prior as jprior
from kandinsky2_tpu.models import text_encoders as jte
from kandinsky2_tpu_torch.models import movq as tmovq
from kandinsky2_tpu_torch.models import prior as tprior
from kandinsky2_tpu_torch.models import text_encoders as tte
from kandinsky2_tpu_torch.pipelines.kandinsky2_1 import MOVQ_UNPORTED
from kandinsky2_tpu_torch.weights.from_jax import load_jax_params
from test_torch_common import MODULE_TOL, assert_close, numpy_params, small_config

T = torch.from_numpy


def test_movq_decode():
    dd = small_config()["image_enc_params"]["params"]["ddconfig"]
    kw = dict(ch=dd["ch"], ch_mult=tuple(dd["ch_mult"]),
              num_res_blocks=dd["num_res_blocks"],
              attn_resolutions=tuple(dd["attn_resolutions"]),
              resolution=dd["resolution"])
    jm = jmovq.MOVQ(n_embed=64, **kw)
    params = numpy_params(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 0)
    z = np.random.RandomState(1).randn(1, 8, 8, 4).astype(np.float32)
    want = jax.jit(lambda p, z: jm.apply(p, z, method=jm.decode))(params, z)
    tm = load_jax_params(tmovq.MOVQ(**kw), params["params"],
                         skip_prefixes=MOVQ_UNPORTED)
    with torch.no_grad():
        got = tm.decode(T(z))
    assert got.shape == (1, 64, 64, 3)
    assert_close(got, want, MODULE_TOL, "MOVQ.decode")


def test_prior_transformer():
    hp = small_config()["prior"]["params"]["model"]["hparams"]
    kw = dict(text_ctx=hp["text_ctx"], xf_width=hp["xf_width"],
              xf_layers=hp["xf_layers"], xf_heads=hp["xf_heads"],
              clip_dim=hp["clip_dim"], clip_xf_width=hp["clip_xf_width"])
    rng = np.random.RandomState(2)
    B = 2
    x = rng.randn(B, hp["clip_dim"]).astype(np.float32)
    ts = np.array([17.0, 3.0], np.float32)
    emb = rng.randn(B, hp["clip_dim"]).astype(np.float32)
    enc = rng.randn(B, hp["text_ctx"], hp["clip_xf_width"]).astype(np.float32)
    mask = np.zeros((B, hp["text_ctx"]), bool)
    mask[0, :5] = mask[1, :8] = True
    jm = jprior.PriorTransformer(**kw)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, ts, emb, enc, mask), 3)
    want = jax.jit(jm.apply)(params, x, ts, emb, enc, mask)
    tm = load_jax_params(tprior.PriorTransformer(**kw), params["params"])
    with torch.no_grad():
        got = tm(T(x), T(ts), T(emb), T(enc), T(mask))
    assert_close(got, want, MODULE_TOL, "PriorTransformer")


def test_clip_towers():
    cfg = small_config()
    tp, vp = cfg["clip_text_params"], cfg["clip_vision_params"]
    rng = np.random.RandomState(4)
    tokens = rng.randint(1, tp["vocab_size"], (2, tp["context_length"])).astype(np.int32)
    jt = jte.CLIPTextTower(**tp)
    params = numpy_params(jax.eval_shape(jt.init, jax.random.PRNGKey(0), tokens), 5)
    want_seq, want_feat = jax.jit(jt.apply)(params, tokens)
    tt = load_jax_params(tte.CLIPTextTower(**tp), params["params"])
    with torch.no_grad():
        seq, feat = tt(T(tokens).long())
    assert_close(seq, want_seq, MODULE_TOL, "CLIP text seq")
    assert_close(feat, want_feat, MODULE_TOL, "CLIP text feat")

    img = rng.randn(2, vp["image_size"], vp["image_size"], 3).astype(np.float32)
    jv = jte.CLIPViT(**vp)
    params = numpy_params(jax.eval_shape(jv.init, jax.random.PRNGKey(0), img), 6)
    want = jax.jit(jv.apply)(params, img)
    tv = load_jax_params(tte.CLIPViT(**vp), params["params"])
    with torch.no_grad():
        got = tv(T(img))
    assert_close(got, want, MODULE_TOL, "CLIP ViT")


def test_xlmr_multilingual_clip():
    te = small_config()["text_enc_params"]
    kw = dict(model_name="multiclip", in_features=te["in_features"],
              out_features=te["out_features"], layers=te["layers"],
              heads=te["heads"], intermediate=te["intermediate"],
              vocab_size=te["vocab_size"], max_positions=te["max_positions"])
    rng = np.random.RandomState(7)
    tokens = rng.randint(2, te["vocab_size"], (2, 10)).astype(np.int32)
    mask = np.zeros((2, 10), np.int32)
    mask[0, :4] = mask[1, :10] = 1
    jm = jte.TextEncoder(**kw)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), tokens, mask), 8)
    want_full, want_pooled = jax.jit(jm.apply)(params, tokens, mask)
    tm = load_jax_params(tte.TextEncoder(**kw), params["params"])
    with torch.no_grad():
        full, pooled = tm(T(tokens).long(), T(mask))
    assert_close(full, want_full, MODULE_TOL, "XLM-R full")
    assert_close(pooled, want_pooled, MODULE_TOL, "mCLIP pooled")
