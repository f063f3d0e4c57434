"""Gradients through the port's autograd Functions against the JAX
package's ``custom_vjp``s, in fp32 on the CPU (where the Functions run the
plain versions of the kernels), at 1e-4:

* ``FlashAttentionFunction`` (K3 forward, K5 + K4 backward on the card)
  against ``jax.grad`` of the Pallas ``flash_attention`` in interpret mode
  (its ``_flash_bwd_bhd`` kernels), with ragged T and S; and the plain
  backward alone against ``_flash_bwd_bhd`` from the same O and LSE;
* ``GroupNormFunction`` (K1 + K2 forward, recompute backward) against
  ``jax.vjp`` of ``pallas_group_norm`` in interpret mode, with and without
  FiLM and SiLU.

Each also shows that the Function, not bare autograd of the plain path,
carries the gradient: the output's ``grad_fn`` is the Function's node.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kandinsky2_tpu.ops.flash_attention import _blocks, _flash_bhd, _flash_bwd_bhd
from kandinsky2_tpu.ops.flash_attention import flash_attention as jflash
from kandinsky2_tpu.ops.group_norm import pallas_group_norm
from kandinsky2_tpu_torch.ops import group_norm as tgn
from kandinsky2_tpu_torch.ops.attention import qkv_attention
from kandinsky2_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
)
from test_torch_common import MODULE_TOL, assert_close

T = torch.from_numpy


@pytest.mark.parametrize("B,T_,S,H,d", [
    (2, 36, 43, 2, 64),  # UNet-like: encoder tokens prepended, neither a tile multiple
    (1, 20, 29, 3, 32),
    (1, 64, 64, 1, 64),
])
def test_flash_attention_gradients_match_pallas_vjp(B, T_, S, H, d):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, L, H, d).astype(np.float32) for L in (T_, S, S))
    g = rng.randn(B, T_, H, d).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jflash(q, k, v, interpret=True) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (T(a).requires_grad_() for a in (q, k, v))
    o = flash_attention(tq, tk, tv)[0]
    assert type(o.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    got = torch.autograd.grad(o, (tq, tk, tv), T(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert_close(a, b, MODULE_TOL, name)


def test_qkv_attention_goes_through_the_function():
    """Where the routing rule sends a call to the kernels (bf16, d = 64,
    a gradient needed) it goes through the autograd Function; an fp32 call
    runs the reference semantics, differentiated by autograd."""
    rng = np.random.RandomState(1)
    q, k, v = (T(rng.randn(1, L, 2, 64).astype(np.float32)).bfloat16()
               .requires_grad_() for L in (5, 9, 9))
    assert type(qkv_attention(q, k, v).grad_fn).__name__ == \
        "FlashAttentionFunctionBackward"
    q, k, v = (T(rng.randn(1, L, 2, 16).astype(np.float32)).requires_grad_()
               for L in (5, 9, 9))
    assert type(qkv_attention(q, k, v).grad_fn).__name__ != \
        "FlashAttentionFunctionBackward"


def test_plain_backward_from_saved_lse():
    """``flash_attention_bwd_plain`` from the forward's O and LSE equals
    autograd through the plain forward."""
    rng = np.random.RandomState(2)
    q, k, v = (T(rng.randn(2, L, 2, 64).astype(np.float32)).requires_grad_()
               for L in (11, 17, 17))
    do = T(rng.randn(2, 11, 2, 64).astype(np.float32))
    o, lse = flash_attention(q, k, v)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = flash_attention_bwd_plain(q, k, v, o, lse, do)
    for a, b in zip(got, want):
        assert_close(a, b, MODULE_TOL)


def test_backward_kernel_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((1, 8, 1, 64), device="meta")
    lse = torch.empty((1, 8), device="meta")
    with pytest.raises(RuntimeError):
        flash_attention_bwd_dq(x, x, x, x, x, lse)  # q, k, v, o, dO, lse
    with pytest.raises(RuntimeError):
        flash_attention_bwd_dkv(x, x, x, x, lse, lse)  # q, k, v, dO, lse, delta


@pytest.mark.parametrize("B,T_,S,H", [(2, 36, 43, 2), (1, 20, 29, 3), (1, 64, 64, 1)])
def test_plain_backward_matches_pallas_kernels(B, T_, S, H):
    """``flash_attention_bwd`` on CPU tensors (the plain backward, which
    the card's K5 and K4 are held against) from the Pallas forward's O and
    LSE, against the Pallas ``_flash_bwd_bhd`` (interpret mode) from the
    same O and LSE, fp32, at 1e-4."""
    d = 64
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(B * H, L, d).astype(np.float32) for L in (T_, S, S))
    g = rng.randn(B * H, T_, d).astype(np.float32)
    bq, bk = _blocks(256, 256, T_, S)
    o, lse_pad = _flash_bhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq, bk, True)
    want = _flash_bwd_bhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse_pad,
                          jnp.asarray(g), bq, bk, True)
    # the port's layout: [B, L, H, d] and LSE [B*H, T]
    port = lambda x: T(np.array(x)).reshape(B, H, -1, d).permute(0, 2, 1, 3)
    tq, tk, tv, to, tg = (port(x) for x in (q, k, v, o, g))
    lse = T(np.asarray(lse_pad)[:, :T_, 0].copy())
    got = flash_attention_bwd(tq, tk, tv, to, lse, tg)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert_close(a, port(b), MODULE_TOL, name)


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("swish", [0.0, 1.0])
def test_group_norm_gradients_match_pallas_vjp(film, swish):
    rng = np.random.RandomState(3)
    shape = (2, 6, 8, 128)
    C = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.7).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    fs = (0.3 * rng.randn(2, C)).astype(np.float32)
    fb = rng.randn(2, C).astype(np.float32)
    gy = rng.randn(*shape).astype(np.float32)
    args = [x, scale, bias] + ([fs, fb] if film else [])

    def jfn(x, scale, bias, *f):
        return pallas_group_norm(x, scale, bias, 32, 1e-5, swish=swish,
                                 film=tuple(f) if f else None, interpret=True)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(gy))
    targs = [T(a).requires_grad_() for a in args]
    y = tgn.group_norm(*targs[:3], 32, 1e-5, swish=swish,
                       film=tuple(targs[3:]) if film else None)
    assert type(y.grad_fn).__name__ == "GroupNormFunctionBackward"
    got = torch.autograd.grad(y, targs, T(gy))
    for name, a, b in zip(("x", "scale", "bias", "fs", "fb"), got, want):
        assert_close(a, b, MODULE_TOL, name)


def test_group_norm_gradient_only_where_asked():
    """Inputs that need no gradient get None; FiLM of shape [B, 1, 1, C]
    gets a gradient of that shape."""
    rng = np.random.RandomState(4)
    x = T(rng.randn(2, 4, 4, 64).astype(np.float32))
    scale = T(np.ones(64, np.float32)).requires_grad_()
    bias = T(np.zeros(64, np.float32))
    fs = T(0.1 * rng.randn(2, 1, 1, 64).astype(np.float32)).requires_grad_()
    fb = T(rng.randn(2, 1, 1, 64).astype(np.float32))
    y = tgn.group_norm(x, scale, bias, 32, 1e-6, swish=1.0, film=(fs, fb))
    y.sum().backward()
    assert x.grad is None and bias.grad is None and fb.grad is None
    assert scale.grad.shape == (64,) and fs.grad.shape == (2, 1, 1, 64)


@pytest.mark.parametrize("grad_off", [torch.no_grad, torch.inference_mode])
def test_grad_mode_off_skips_the_functions(grad_off):
    """With grad mode off, as in serving, group_norm and flash_attention call
    their forward directly: the same outputs as through the Functions, and
    no graph."""
    rng = np.random.RandomState(5)
    x = T(rng.randn(2, 4, 4, 64).astype(np.float32))
    scale, bias = T(1 + 0.1 * rng.randn(64).astype(np.float32)), T(np.zeros(64, np.float32))
    film = tuple(T(rng.randn(2, 64).astype(np.float32)) for _ in range(2))
    q, k, v = (T(rng.randn(1, L, 2, 64).astype(np.float32)) for L in (7, 12, 12))
    y_fn = tgn.group_norm(x, scale, bias, 32, 1e-5, swish=1.0, film=film)
    o_fn, lse_fn = flash_attention(q, k, v)
    with grad_off():
        y = tgn.group_norm(x, scale, bias, 32, 1e-5, swish=1.0, film=film)
        o, lse = flash_attention(q, k, v)
    assert y.grad_fn is None and o.grad_fn is None
    assert torch.equal(y, y_fn) and torch.equal(o, o_fn) and torch.equal(lse, lse_fn)
