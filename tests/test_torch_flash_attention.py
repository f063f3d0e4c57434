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



def _bf(*shape, dtype=torch.bfloat16, grad=False):
    return torch.randn(shape).to(dtype).requires_grad_(grad)


@pytest.mark.parametrize("d,dtype,grad,kernel", [
    (64, torch.bfloat16, False, True),
    (512, torch.bfloat16, False, True),
    (64, torch.bfloat16, True, True),  # the backward is built for d = 64
    (512, torch.bfloat16, True, False),  # ... and for no other head dim
    (64, torch.float32, False, False),
    (512, torch.float32, False, False),
    (32, torch.bfloat16, False, False),
    (128, torch.bfloat16, False, False),
])
def test_attention_routing_rule(d, dtype, grad, kernel):
    """``use_flash_kernel`` decides from dtype, head dim and whether a
    gradient is needed; ``qkv_attention`` follows it on the CPU too, to the
    kernel's plain version or to the reference semantics."""
    from kandinsky2_tpu_torch.ops import attention as att
    from kandinsky2_tpu_torch.ops.flash_attention import flash_attention_plain

    q, k, v = (_bf(1, 5, 2, d, dtype=dtype, grad=grad) for _ in range(3))
    assert att.use_flash_kernel(q, k, v) is kernel
    with torch.no_grad():  # no gradient needed: the forward's head dims
        assert att.use_flash_kernel(q, k, v) is (
            dtype == torch.bfloat16 and d in (64, 512))
    want = (flash_attention_plain(q, k, v)[0] if kernel
            else att.reference_attention(q, k, v))
    torch.testing.assert_close(att.qkv_attention(q, k, v), want, rtol=0, atol=0)


def test_movq_and_unet_attention_take_the_rule(monkeypatch):
    """The MoVQ ``AttnBlock`` and the UNet's ``AttentionBlock`` both reach
    the flash kernel through ``qkv_attention`` only where the rule says:
    never in fp32."""
    from kandinsky2_tpu_torch.models.movq import AttnBlock
    from kandinsky2_tpu_torch.models.unet import AttentionBlock
    from kandinsky2_tpu_torch.ops import attention as att

    calls = []
    monkeypatch.setattr(att, "flash_attention",
                        lambda q, k, v: calls.append(q.dtype) or (q, None))
    x = torch.randn(1, 4, 4, 64)
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            AttnBlock(64, dtype=dtype).to(dtype)(x.to(dtype))
            AttentionBlock(64, 1, 32, dtype=dtype).to(dtype)(
                x.to(dtype), torch.randn(1, 3, 32).to(dtype))
    assert calls == [torch.bfloat16, torch.bfloat16]
