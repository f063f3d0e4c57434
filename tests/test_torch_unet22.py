"""The port's Kandinsky 2.2 decoder UNet (``kandinsky2_tpu_torch/models/
unet22.py``) against the JAX package's ``UNet22`` on the CPU in fp32, with
the same numpy-seeded parameters through the bridge: ``denoise`` and
``denoise_cached`` at 4 (text2img), 9 (inpainting) and 8 (ControlNet, with
the hint stack) input channels, at head width 32 (the plain route) and 64
(K3's plain version), at the per-module tolerance; the timestep embedding's
[sin, cos] order; and K3's plain version against the JAX package's Pallas
flash kernel in interpret mode at the ragged S = T + image tokens of the
added-KV attention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kandinsky2_tpu.models import unet22 as junet22
from kandinsky2_tpu.ops.flash_attention import _flash_bhd
from kandinsky2_tpu_torch.models import unet22 as tunet22
from kandinsky2_tpu_torch.ops import attention as tattn
from kandinsky2_tpu_torch.ops.flash_attention import flash_attention_plain
from kandinsky2_tpu_torch.weights.from_jax import load_jax_params
from test_torch_common import MODULE_TOL, assert_close, flash_route, numpy_params

# test_pipeline22.py's TINY UNet, and a 64-wide-head variant
TINY = dict(block_out_channels=(32, 64), layers_per_block=1, attention_head_dim=32,
            cross_attention_dim=32, encoder_hid_dim=32, num_image_tokens=2)
WIDE = dict(TINY, block_out_channels=(64, 128), attention_head_dim=64)
IN_CHANNELS = {"text2img": 4, "inpainting": 9, "controlnet": 8}


def _pair(cfg, task, seed=3):
    kw = dict(cfg, in_channels=IN_CHANNELS[task],
              controlnet_hint=task == "controlnet")
    ju = junet22.UNet22(**kw)
    x_ch = 4 if task == "controlnet" else kw["in_channels"]
    hint = {"hint": jnp.zeros((1, 64, 64, 3))} if task == "controlnet" else {}
    shapes = jax.eval_shape(lambda k: ju.init(
        k, jnp.zeros((1, 8, 8, x_ch)), jnp.zeros((1,)),
        jnp.zeros((1, cfg["encoder_hid_dim"])), **hint), jax.random.PRNGKey(0))
    params = numpy_params(shapes["params"], seed)
    tu = tunet22.UNet22(**kw)
    load_jax_params(tu, params)
    return ju, tu, params, x_ch


def _inputs(cfg, x_ch, task):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 8, 8, x_ch).astype(np.float32)
    t = np.array([981.0, 20.0], np.float32)
    emb = rng.randn(2, cfg["encoder_hid_dim"]).astype(np.float32)
    hint = rng.rand(2, 64, 64, 3).astype(np.float32) if task == "controlnet" else None
    return x, t, emb, hint


def _route(monkeypatch, cfg):
    """At head width 64, K3's route (its plain version on the CPU) for the
    fp32 added-KV attention, which the routing rule keeps for bf16."""
    return flash_route(monkeypatch) if cfg["attention_head_dim"] == 64 else None


@pytest.mark.parametrize("task", list(IN_CHANNELS))
@pytest.mark.parametrize("cfg", [TINY, WIDE], ids=["head32", "head64"])
def test_denoise_matches_jax(monkeypatch, cfg, task):
    ju, tu, params, x_ch = _pair(cfg, task)
    x, t, emb, hint = _inputs(cfg, x_ch, task)
    hkw = {} if hint is None else {"hint": jnp.asarray(hint)}
    want = jax.jit(lambda p, x, t, e, **kw: ju.apply({"params": p}, x, t, e, **kw))(
        params, x, t, emb, **hkw)
    calls = _route(monkeypatch, cfg)
    T = torch.from_numpy
    with torch.no_grad():
        got = tu(T(x), T(t), T(emb), None if hint is None else T(hint))
    assert_close(got, want, MODULE_TOL, f"UNet22 {task}")
    if calls is not None:  # 6 attentions (1 down, 1 middle, 2 + 2 up), each
        # with the image tokens before the T rows
        assert [k[1] - q[1] for q, k in calls] == [cfg["num_image_tokens"]] * 6


@pytest.mark.parametrize("task", list(IN_CHANNELS))
@pytest.mark.parametrize("cfg", [TINY, WIDE], ids=["head32", "head64"])
def test_denoise_cached_matches_jax(monkeypatch, cfg, task):
    """A refresh call, then a cached call on the refreshed deep feature: the
    outputs and the cache against JAX's."""
    ju, tu, params, x_ch = _pair(cfg, task)
    x, t, emb, hint = _inputs(cfg, x_ch, task)
    hkw = {} if hint is None else {"hint": jnp.asarray(hint)}
    cond = ju.apply({"params": params}, jnp.asarray(emb),
                    method=junet22.UNet22.encode_conditioning, **hkw)
    cache0 = jnp.zeros((2, 8, 8, junet22.deep_cache_spec22(ju)[1]))

    def jcall(x, cache, refresh):
        return ju.apply({"params": params}, x, t, *cond, cache, refresh,
                        method=junet22.UNet22.denoise_cached)

    want1, wcache = jax.jit(jcall, static_argnums=2)(x, cache0, True)
    want2, _ = jax.jit(jcall, static_argnums=2)(0.5 * x, wcache, False)
    _route(monkeypatch, cfg)
    T = torch.from_numpy
    with torch.no_grad():
        tcond = tu.encode_conditioning(T(emb), None if hint is None else T(hint))
        got1, gcache = tu.denoise_cached(T(x), T(t), *tcond, None, True)
        got2, _ = tu.denoise_cached(T(0.5 * x), T(t), *tcond, gcache, False)
        full = tu.denoise(T(x), T(t), *tcond)
    assert tunet22.deep_cache_spec22(tu) == junet22.deep_cache_spec22(ju)
    assert_close(got1, want1, MODULE_TOL, "refresh")
    assert_close(gcache, wcache, MODULE_TOL, "cache")
    assert_close(got2, want2, MODULE_TOL, "cached")
    assert torch.equal(full, got1)


def test_timestep_embedding_sin_cos_order():
    t = np.array([0.0, 3.0, 999.0], np.float32)
    want = junet22.timestep_embedding_22(jnp.asarray(t), 64)
    got = tunet22.timestep_embedding_22(torch.from_numpy(t), 64)
    assert_close(got, want, MODULE_TOL, "timestep_embedding_22")
    assert float(got[0, 0]) == 0.0 and float(got[0, 32]) == 1.0  # sin 0, cos 0


@pytest.mark.parametrize("T,n_tokens,H", [(64, 10, 2), (144, 10, 3), (100, 2, 1)])
def test_added_kv_flash_plain_matches_pallas_interpret(T, n_tokens, H):
    """K3's plain version against the JAX Pallas flash kernel in interpret
    mode at S = T + n_tokens (ragged against the 64-row blocks), and both
    against ``AddedKVAttention``'s own formula."""
    rng = np.random.RandomState(T)
    B, d = 2, 64
    S = T + n_tokens
    q, k, v = (rng.randn(B, L, H, d).astype(np.float32) for L in (T, S, S))
    bhd = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(B * H, -1, d)
    out, _ = _flash_bhd(bhd(q), bhd(k), bhd(v), block_q=64, block_k=64, interpret=True)
    want = np.asarray(out).reshape(B, H, T, d).transpose(0, 2, 1, 3)
    T_ = torch.from_numpy
    got, _ = flash_attention_plain(T_(q), T_(k), T_(v))
    assert_close(got, want, MODULE_TOL, "plain K3 vs Pallas")
    ref = tattn.added_kv_reference_attention(T_(q), T_(k), T_(v))
    assert_close(ref, want, MODULE_TOL, "added-KV formula vs Pallas")
