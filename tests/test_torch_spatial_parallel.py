"""Spatial (row) parallelism of the port (``kandinsky2_tpu_torch/parallel``)
against the JAX package, on the CPU in fp32.

The port runs one process per shard: one pool of four gloo ranks on
loopback serves every case of this file (``torch_sp_ranks``, the rank
side), each case on its first 2 or 4 ranks.  The JAX side runs in this
process on the virtual devices of ``tests/conftest.py``:

* the primitives (halo rows, the sharded GroupNorm, both attention
  implementations, the multi-head ring with a text prefix, the dynamic
  threshold) against JAX's own sharded functions under ``shard_map``;
* the codecs and the UNet against JAX's unsharded modules (the JAX tests
  hold its sharded programs equal to them at 1e-4, and compiling those
  programs takes minutes on the CPU), and against the port's unsharded
  modules on the ranks;

at 1e-4 each; the sharded GroupNorm at mean/std 1000 within 1e-4 of fp64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_sp_ranks as ranks
from kandinsky2_tpu.models import movq as jmovq
from kandinsky2_tpu.models.layers import GroupNorm32 as JaxGroupNorm32
from kandinsky2_tpu.models.unet import UNetModel as JaxUNet
from kandinsky2_tpu.parallel import spatial as jsp
from kandinsky2_tpu_torch.models import movq as tmovq
from kandinsky2_tpu_torch.parallel.launch import RankPool
from kandinsky2_tpu_torch.parallel.mesh import MeshAxis
from kandinsky2_tpu_torch.weights.from_jax import load_jax_params
from test_torch_common import MODULE_TOL, assert_close, numpy_params

ROW = P(None, "sp", None, None)
# tests/test_spatial_parallel.py's codec: latent 16x16 -> image 64x64,
# attention at the bottleneck (16) and one up level (32)
MOVQ_KW = dict(z_channels=4, embed_dim=4, n_embed=64, ch=32, ch_mult=(1, 2, 2),
               num_res_blocks=1, attn_resolutions=(16, 32), resolution=64)
KL_KW = dict(z_channels=4, embed_dim=4, ch=32, ch_mult=(1, 2, 2), num_res_blocks=1,
             attn_resolutions=(16,), resolution=64)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, device="cpu")
    p.start()  # the ranks join while the JAX side compiles
    yield p
    p.close()


def jax_sharded(fn, n, in_specs=ROW, out_specs=ROW):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def rand(seed, *shape, scale=1.0, loc=0.0):
    return (loc + scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("below", [False, True])
def test_halo_rows_match_zero_pad_and_jax(pool, n, below):
    x = rand(1, 2, 16, 8, 3)
    blocks = pool.run(ranks.halo, n, x, below)[0]
    jf = jsp.halo_below_rows if below else jsp.halo_exchange_rows
    want = np.asarray(jax_sharded(lambda b: jf(b, "sp"), n)(x))
    ref = np.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0)))
    hl, extra = 16 // n, 1 if below else 2
    for d in range(n):
        start = d * hl + (1 if below else 0)
        np.testing.assert_array_equal(blocks[d], ref[:, start:start + hl + extra])
        block = want[:, d * (hl + extra):(d + 1) * (hl + extra)]
        np.testing.assert_array_equal(blocks[d], block)


GN_CASES = {
    "plain": dict(C=64, groups=32, swish=0.0, film=False, loc=0.0, scale=1.0),
    "silu film": dict(C=64, groups=32, swish=1.0, film=True, loc=0.5, scale=2.0),
    "groups 8": dict(C=32, groups=8, swish=0.0, film=False, loc=-3.0, scale=0.5),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(GN_CASES))
def test_sharded_group_norm_matches_jax(pool, n, case):
    c = GN_CASES[case]
    C, B = c["C"], 2
    x = rand(2, B, 16, 8, C, scale=c["scale"], loc=c["loc"])
    scale, bias = 1 + rand(3, C, scale=0.1), rand(4, C, scale=0.1)
    film = (rand(5, B, 1, 1, C, scale=0.1), rand(6, B, 1, 1, C, scale=0.1)) \
        if c["film"] else None
    got, whole = pool.run(ranks.group_norm, n, x, scale, bias, c["groups"], 1e-5,
                          c["swish"], film)[0]
    jm = JaxGroupNorm32(num_groups=c["groups"], eps=1e-5, swish=c["swish"],
                        axis_name="sp")
    params = {"params": {"scale": scale, "bias": bias}}
    if film is None:
        want = jax_sharded(lambda a: jm.apply(params, a), n)(x)
    else:
        want = jax_sharded(lambda a, f0, f1: jm.apply(params, a, film=(f0, f1)), n,
                           in_specs=(ROW, P(), P()))(x, *film)
    assert_close(got, want, MODULE_TOL, f"GroupNorm {case} sp{n} vs JAX")
    assert_close(got, whole, MODULE_TOL, f"GroupNorm {case} sp{n} vs unsharded")


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_group_norm_far_mean_matches_fp64(pool, n):
    """Each group's mean lies 1000 standard deviations from zero, where the
    shards' different pivots would show if their sums were added as they
    are: within 1e-4 relative L2 of the norm in fp64."""
    B, C, G = 2, 64, 32
    rng = np.random.RandomState(7)
    x = (1000.0 + rng.randn(B, 16, 8, C)).astype(np.float32)
    ones, zeros = np.ones(C, np.float32), np.zeros(C, np.float32)
    got, _ = pool.run(ranks.group_norm, n, x, ones, zeros, G, 1e-5, 0.0, None)[0]
    xd = x.astype(np.float64).reshape(B, -1, G, C // G)
    mean = xd.mean(axis=(1, 3), keepdims=True)
    var = xd.var(axis=(1, 3), keepdims=True)
    truth = ((xd - mean) / np.sqrt(var + 1e-5)).reshape(x.shape)
    rel = np.linalg.norm(got - truth) / np.linalg.norm(truth)
    assert rel <= 1e-4, f"sharded GroupNorm at mean/std 1000: {rel:.3e} from fp64"


def _jax_attention(q, k, v):
    B, H, W, C = q.shape
    logits = jnp.einsum("btc,bsc->bts", q.reshape(B, H * W, C),
                        k.reshape(B, H * W, C)) * (C ** -0.5)
    w = jax.nn.softmax(logits, axis=-1)
    return jnp.einsum("bts,bsc->btc", w, v.reshape(B, H * W, C)).reshape(B, H, W, C)


@pytest.mark.parametrize("impl", ["gathered", "ring"])
def test_sp_attention_rows_match_jax(pool, impl):
    q, k, v = (rand(30 + i, 2, 8, 4, 16) for i in range(3))
    got, dtype = pool.run(ranks.attention_rows, 4, q, k, v, impl)[0]
    want = jax_sharded(lambda a, b, c: jsp.sp_attention_rows(a, b, c, "sp", impl=impl),
                       4)(q, k, v)
    assert dtype == "torch.float32"
    assert_close(got, want, MODULE_TOL, f"sp_attention_rows {impl}")
    assert_close(got, _jax_attention(q, k, v), MODULE_TOL, f"{impl} vs one device")


def test_ring_attention_rows_query_chunking_matches_jax(pool):
    """A query chunk that does not divide the local rows (12 tokens, chunks
    of 5)."""
    q, k, v = (rand(40 + i, 1, 8, 6, 8) for i in range(3))
    got, _ = pool.run(ranks.attention_rows, 4, q, k, v, "ring", q_chunk=5)[0]
    want = jax_sharded(
        lambda a, b, c: jsp.sp_ring_attention_rows(a, b, c, "sp", q_chunk=5), 4)(q, k, v)
    assert_close(got, want, MODULE_TOL, "sp_ring_attention_rows q_chunk 5")


def test_ring_attention_mh_text_prefix_matches_jax(pool):
    """The UNet's ring: spatial K/V around the ring, the encoder K/V as a
    replicated prefix folded first, queries in chunks of 4."""
    B, T, H, c, E = 2, 24, 3, 8, 5
    q, k, v = (rand(70 + i, B, T, H, c) for i in range(3))
    ek, ev = (rand(73 + i, B, E, H, c) for i in range(2))
    got = pool.run(ranks.ring_mh, 4, q, k, v, ek, ev, 4)[0]
    spec = P(None, "sp", None, None)
    want = jax_sharded(
        lambda a, b, cc, d, e: jsp.sp_ring_attention_mh(a, b, cc, "sp", extra_k=d,
                                                       extra_v=e, q_chunk=4),
        4, in_specs=(spec, spec, spec, P(), P()), out_specs=spec)(q, k, v, ek, ev)
    assert_close(got, want, MODULE_TOL, "sp_ring_attention_mh")


@pytest.mark.parametrize("n", [2, 4])
def test_dynamic_threshold_axis_matches_jax(pool, n):
    from kandinsky2_tpu.diffusion.gaussian import dynamic_threshold

    x = rand(52, 2, 16, 8, 4, scale=3.0)
    got, whole = pool.run(ranks.threshold, n, x)[0]
    want = jax_sharded(lambda b: dynamic_threshold(b, axis_name="sp"), n)(x)
    assert_close(got, want, 1e-6, "dynamic_threshold over the axis")
    assert_close(got, whole, 1e-6, "dynamic_threshold vs unsharded")


@pytest.fixture(scope="module")
def codecs():
    """JAX's MoVQ and KL-VAE with numpy-seeded parameters."""
    x = jnp.zeros((1, 64, 64, 3))
    out = {}
    for kind, cls, kw, seed in (("movq", jmovq.MOVQ, MOVQ_KW, 0),
                                ("kl", jmovq.AutoencoderKL, KL_KW, 4)):
        jm = cls(**kw)
        params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), seed)
        out[kind] = (jm, params["params"])
    return out


# (codec, method, n, input): tests/test_spatial_parallel.py's cases
CODEC_CASES = {
    "movq decode_code sp2": ("movq", "decode_code", 2, "codes"),
    "movq decode_code sp4": ("movq", "decode_code", 4, "codes"),
    "movq decode sp4": ("movq", "decode", 4, "quant"),
    "kl decode sp4": ("kl", "decode", 4, "quant"),
    "movq encode sp4": ("movq", "encode", 4, "image"),
    "kl encode sp2": ("kl", "encode", 2, "image"),
}


@pytest.mark.parametrize("case", list(CODEC_CASES))
def test_spatial_codec_matches_jax(pool, codecs, case):
    kind, method, n, what = CODEC_CASES[case]
    jm, params = codecs[kind]
    x = {"codes": np.random.RandomState(2).randint(0, 64, (2, 16, 16)),
         "quant": rand(3, 2, 16, 16, 4),
         "image": rand(7, 2, 64, 64, 3)}[what]
    kw = MOVQ_KW if kind == "movq" else KL_KW
    got, whole = pool.run(ranks.codec, n, kind, kw, params, x, method)[0]
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a,
                                         method=getattr(type(jm), method)))(params, x)
    if isinstance(want, tuple):
        want = np.stack([np.asarray(w) for w in want])
    assert_close(got, want, MODULE_TOL, f"{case} vs JAX")
    assert_close(got, whole, MODULE_TOL, f"{case} vs unsharded")


def test_row_checks_match_jax(pool, codecs):
    """``spatial_decode``'s divisibility error and ``check_sp_rows``'s
    message, word for word as JAX's."""
    _, params = codecs["movq"]
    msgs = pool.run(ranks.row_errors, "movq", MOVQ_KW, params)[0]
    jm, jparams = codecs["movq"]
    want = []
    for call in (lambda: jsp.spatial_decode(jm, jparams, jnp.zeros((1, 14, 16, 4)),
                                            Mesh(np.asarray(jax.devices()[:4]), ("sp",)),
                                            method="decode"),
                 lambda: jsp.check_sp_rows(72, 4, 3, what="image height")):
        with pytest.raises(ValueError) as err:
            call()
        want.append(str(err.value))
    assert msgs == want
    assert "divide" in msgs[0] and "multiple" in msgs[1]


UNET_KW = dict(in_channels=4, model_channels=32, out_channels=8, num_res_blocks=1,
               attention_resolutions=(1, 2), channel_mult=(1, 2), num_heads=1,
               num_head_channels=16)


@pytest.mark.parametrize("updown,ring", [(True, False), (False, False), (True, True)],
                         ids=["resblock_updown", "conv_updown", "ring attention"])
def test_spatial_unet_matches_jax(pool, updown, ring):
    """The row-sharded UNet forward (halo convs through conv_in, ResBlocks,
    Downsample and the output head; sharded GroupNorms with FiLM; gathered,
    or ring, attention with encoder tokens) against JAX's
    ``test_spatial_unet_matches_single_device`` model."""
    jm = JaxUNet(**UNET_KW, resblock_updown=updown, use_encoder_kv=True)
    B = 1 if ring else 2
    x = rand(8, B, 16, 16, 4)
    t = np.asarray([3.0, 7.0][:B], np.float32)
    enc = rand(9, B, 5, 32)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, t, enc), 10)
    want = jax.jit(lambda p: jm.apply(p, x, t, enc))(params)
    kw = dict(UNET_KW, resblock_updown=updown, encoder_channels=32)
    got, whole = pool.run(ranks.unet, 4, kw, params["params"], x, t, enc, ring)[0]
    assert_close(got, want, MODULE_TOL, "sharded UNet vs JAX")
    assert_close(got, whole, MODULE_TOL, "sharded UNet vs unsharded")


def test_one_state_dict_serves_both_layouts(codecs):
    """The JAX parameters load through the bridge into the sharded and the
    unsharded MoVQ alike: the same keys and the same tensors."""
    _, params = codecs["movq"]
    axis = MeshAxis("sp", None, 4, 0, (0, 1, 2, 3), "gloo")
    plain = load_jax_params(tmovq.MOVQ(**MOVQ_KW), params)
    sharded = load_jax_params(tmovq.MOVQ(**MOVQ_KW, sp_axis=axis), params)
    assert sharded.decoder.mid.attn_1.sp_axis is axis
    a, b = plain.state_dict(), sharded.state_dict()
    assert list(a) == list(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.mark.slow
@pytest.mark.parametrize("what", ["movq decode_code", "unet resblock_updown"])
def test_spatial_codec_and_unet_match_jax_sharded(pool, codecs, what):
    """The port's sharded MoVQ decode and UNet21 forward against JAX's
    sharded programs themselves (``spatial_decode`` and the UNet under
    ``shard_map``) on 4 devices; slow: compiling each JAX program takes
    minutes on the CPU."""
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("sp",))
    if what == "movq decode_code":
        jm, params = codecs["movq"]
        codes = np.random.RandomState(2).randint(0, 64, (2, 16, 16))
        got, _ = pool.run(ranks.codec, 4, "movq", MOVQ_KW, params, codes,
                          "decode_code", timeout=600)[0]
        want = jsp.spatial_decode(jm, params, codes, mesh, axis="sp")
    else:
        jm = JaxUNet(**UNET_KW, resblock_updown=True, use_encoder_kv=True)
        x, t, enc = rand(8, 2, 16, 16, 4), np.asarray([3.0, 7.0], np.float32), \
            rand(9, 2, 5, 32)
        params = numpy_params(
            jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, t, enc), 10)
        kw = dict(UNET_KW, resblock_updown=True, encoder_channels=32)
        got, _ = pool.run(ranks.unet, 4, kw, params["params"], x, t, enc, timeout=600)[0]
        sp_unet = jm.clone(sp_axis="sp", parent=None)
        want = jax.shard_map(
            lambda p, xx, tt, ee: sp_unet.apply(p, xx, tt, ee), mesh=mesh,
            in_specs=(P(), ROW, P(), P()), out_specs=ROW, check_vma=False,
        )(params, x, t, enc)
    assert_close(got, want, MODULE_TOL, f"{what} vs JAX's sharded program")
