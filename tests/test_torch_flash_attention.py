"""The port's flash-attention forward (``kandinsky2_tpu_torch/ops/
flash_attention.py``; its plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode, and ``qkv_attention`` against
the JAX attention reference, in fp32 at 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kandinsky2_tpu.ops.attention import _xla_attention
from kandinsky2_tpu.ops.flash_attention import _flash_bhd, flash_attention as jflash
from kandinsky2_tpu_torch.ops.attention import qkv_attention
from kandinsky2_tpu_torch.ops.flash_attention import flash_attention
from test_torch_common import MODULE_TOL, assert_close


def _qkv(seed, B, T, S, H, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, d).astype(np.float32)
    k = rng.randn(B, S, H, d).astype(np.float32)
    v = rng.randn(B, S, H, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,T,S,H,d", [
    (2, 36, 36 + 7, 2, 64),  # UNet: encoder tokens prepended, S != T
    (1, 20, 20, 1, 512),  # MoVQ: one head, d = 512
])
def test_plain_matches_pallas_interpret(B, T, S, H, d):
    q, k, v = _qkv(0, B, T, S, H, d)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    got, lse = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert_close(got, want, MODULE_TOL, "output")
    to_bhd = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(
        B * H, a.shape[1], d)
    bq = min(256, max(16, 1 << (T - 1).bit_length()))
    bk = min(256, max(16, 1 << (S - 1).bit_length()))
    _, want_lse = _flash_bhd(to_bhd(q), to_bhd(k), to_bhd(v), bq, bk, True)
    assert_close(lse, np.asarray(want_lse)[:, :T, 0], MODULE_TOL, "lse")


def test_qkv_attention_matches_jax_reference():
    q, k, v = _qkv(1, 2, 16, 23, 3, 32)
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = qkv_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert_close(got, want, MODULE_TOL, "unmasked")
    mask = np.where(np.random.RandomState(2).rand(2, 16, 23) < 0.3, -1e9, 0.0)
    mask[..., 0] = 0.0
    mask = mask.astype(np.float32)
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(mask))
    got = qkv_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                        mask=torch.from_numpy(mask))
    assert_close(got, want, MODULE_TOL, "masked")


def test_wrapper_refuses_devices_without_a_kernel():
    x = torch.empty((1, 8, 1, 64), device="meta")
    with pytest.raises(RuntimeError):
        flash_attention(x, x, x)

