"""The port's hand-written kernels against their plain PyTorch versions on
the card, at the shapes of the 768² 2.1 text2img path, in bf16.

These tests need an NVIDIA GPU and skip without one.  They import no JAX,
so they run where JAX is not installed, without the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from kandinsky2_tpu_torch.ops import group_norm as tgn
from kandinsky2_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape,eps", [
    ((2, 96 * 96, 384), 1e-5), ((2, 12 * 12, 3072), 1e-5),
    ((1, 96 * 96, 512), 1e-6), ((1, 768 * 768, 128), 1e-6),
])
def test_group_norm_kernels_match_plain(gen, shape, eps):
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    C = shape[-1]
    scale = 1 + 0.1 * torch.randn(C, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(C, generator=gen, device="cuda")
    film = (0.1 * torch.randn(shape[0], C, generator=gen, device="cuda"),
            torch.randn(shape[0], C, generator=gen, device="cuda"))
    got = tgn.group_norm(x, scale, bias, 32, eps, swish=1.0, film=film)
    want = tgn.group_norm_plain(x, scale, bias, 32, eps, swish=1.0, film=film)
    torch.cuda.synchronize()
    # bf16 outputs of |y| < 8: one rounding step is at most 2^-5
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -5


@pytest.mark.parametrize("B,T,S,H,d", [
    (2, 2304, 2391, 12, 64), (2, 144, 231, 24, 64), (1, 9216, 9216, 1, 512),
    (1, 100, 77, 1, 512),
])
def test_flash_kernel_matches_plain(gen, B, T, S, H, d):
    q, k, v = (torch.randn((B, L, H, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for L in (T, S, S))
    o, lse = flash_attention(q, k, v)
    o_ref, lse_ref = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    # P is rounded to bf16 before P·V (fp32 in the plain version), and O to
    # bf16 at the end; |o| shrinks as 1/sqrt(S), so the bound is relative
    o_max = o_ref.float().abs().max().item()
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2 * o_max
    assert (lse - lse_ref).abs().max().item() <= 1e-3 * lse_ref.abs().max().item()
