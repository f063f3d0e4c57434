"""The port's hand-written kernels against their plain PyTorch versions on
the card, at the shapes of the 768² 2.1 and 2.2 text2img paths, of the
512² 2.0 path, of DPT-Large's attention and of the training steps (the
2.1 decoder's, and the 2.2 UNet's in LoRA and distillation), in bf16; GroupNorm against fp64 far from zero mean;
GroupNorm's backward kernels against its plain closed form; and the
autograd Functions that carry gradients through them.

These tests need an NVIDIA GPU and skip without one.  They import no JAX,
so they run where JAX is not installed, without the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from kandinsky2_tpu_torch.ops import group_norm as tgn
from kandinsky2_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_fwd,
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
    # the 2.0 path: Text2ImUNet20 at 512², the KL-VAE decoder and the two
    # layouts only its encoder has
    ((2, 64 * 64, 384), 1e-5), ((2, 8 * 8, 3072), 1e-5),
    ((1, 256 * 256, 512), 1e-6), ((1, 512 * 512, 256), 1e-6),
    ((1, 256 * 256, 128), 1e-6), ((1, 128 * 128, 256), 1e-6),
    # the served 2.1 path at buckets 2 and 4: the UNet's CFG-doubled rows,
    # the MoVQ decoder's batch
    ((4, 96 * 96, 384), 1e-5), ((8, 96 * 96, 384), 1e-5),
    ((4, 12 * 12, 1536), 1e-5), ((8, 12 * 12, 1536), 1e-5),
    ((2, 768 * 768, 128), 1e-6), ((4, 768 * 768, 128), 1e-6),
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


@pytest.mark.parametrize("C", [128, 384, 512, 3072])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_stats_kernel_matches_plain(gen, C, dtype):
    """K1 (one launch: moments, cross-block finish, coefficients with the
    affine pair and FiLM folded in) against its plain version at a ragged N,
    and bitwise equal over two calls."""
    B, N = 2, 1999
    x = (0.5 + torch.randn((B, N, C), generator=gen, device="cuda")).to(dtype)
    scale = (1 + 0.1 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
    bias = (0.1 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
    fsb = torch.randn((B, 1, 1, 2 * C), generator=gen, device="cuda").to(torch.bfloat16)
    for film in (None, fsb.chunk(2, dim=-1)):  # the UNet's strided FiLM views
        got = tgn.group_norm_stats(x, scale, bias, film, 32, 1e-5)
        again = tgn.group_norm_stats(x, scale, bias, film, 32, 1e-5)
        want = tgn.group_norm_stats_plain(x, scale, bias, film, 32, 1e-5)
        torch.cuda.synchronize()
        for g, a, w in zip(got, again, want):
            assert g.dtype == torch.float32 and g.shape == (B, C)
            assert torch.equal(g, a)
            # fp32 sums in another order: about 1e-6 sqrt(N) of the moments
            assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


@pytest.mark.parametrize("swish", [0.0, 1.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [96, 128, 384, 1152, 2688, 3072])
def test_group_norm_apply_kernel_matches_plain(gen, C, dtype, swish):
    """K2 against its plain version, for any swish, at the ds8 N = 144 and a
    ragged N = 1999, on a fresh tensor and on a view two elements past 16
    bytes (narrower loads; a row of more than 1024 loads at that width is
    refused, as K1 refuses it), and bitwise equal over two calls.  The same
    fp32 math up to one fma and the fast activation (tanh.approx in bf16,
    ex2 and rcp in fp32): one rounding to x's dtype, 2^-7 of the largest
    |y| in bf16 and 1e-5 in fp32."""
    B = 2
    a = 1 + 0.5 * torch.randn((B, C), generator=gen, device="cuda")
    b = torch.randn((B, C), generator=gen, device="cuda")
    for N in (144, 1999):
        for offset in (0, 2):
            buf = torch.randn(B * N * C + offset, generator=gen, device="cuda").to(dtype)
            x = buf[offset:].view(B, N, C)
            if C // tgn.vec_width(C, x.data_ptr(), x.element_size()) > 1024:
                with pytest.raises(ValueError):
                    tgn.group_norm_apply(x, a, b, swish)
                continue
            got = tgn.group_norm_apply(x, a, b, swish)
            again = tgn.group_norm_apply(x, a, b, swish)
            want = tgn.group_norm_apply_plain(x, a, b, swish)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == (B, N, C)
            assert torch.equal(got, again), (N, offset)
            ref = max(1.0, want.float().abs().max().item())
            tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * ref
            assert (got.float() - want.float()).abs().max().item() <= tol, (N, offset)


# the UNet21's GroupNorm layouts in the decoder training step, at batch 2:
# ds1 to ds8, the ds8 concatenation and the output head, which runs in fp32
GN_TRAIN_SHAPES = [(2, 96 * 96, 384), (2, 48 * 48, 768), (2, 24 * 24, 1152),
                   (2, 12 * 12, 1536), (2, 12 * 12, 3072)]


def _gn_backward_inputs(gen, shape, dtype, film):
    x = (0.5 + torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    C = shape[-1]
    scale = 1 + 0.1 * torch.randn(C, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(C, generator=gen, device="cuda")
    pair = None
    if film:  # the UNet's strided views of one [B, 1, 1, 2C] embedding
        emb = torch.randn((shape[0], 1, 1, 2 * C), generator=gen, device="cuda")
        pair = tuple((emb * torch.tensor([0.1] * C + [1.0] * C, device="cuda"))
                     .to(dtype).chunk(2, dim=-1))
    gy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return gy, x, scale, bias, pair


@pytest.mark.parametrize("film,swish", [(True, 1.0), (False, 0.0), (False, 0.5)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GN_TRAIN_SHAPES)
def test_group_norm_backward_matches_plain(gen, shape, dtype, film, swish):
    """K1's moments, B1 and B2 (``group_norm_backward``) against the plain
    closed form on the card, at the decoder training step's layouts, and
    bitwise equal over two calls.  In bf16 at K2's tolerance, one rounding
    (2^-7 of the largest value); in fp32 dx within 1e-5 of the largest
    value (K2's: the same fp32 math up to ex2/rcp in the activation and the
    group sums' order), and the FiLM pair, scale and bias, sums over every
    row, within 1e-4 of it (K1's tolerance for its sums)."""
    gy, x, scale, bias, pair = _gn_backward_inputs(gen, shape, dtype, film)
    got = tgn.group_norm_backward(gy, x, scale, bias, 32, 1e-5, swish, pair)
    again = tgn.group_norm_backward(gy, x, scale, bias, 32, 1e-5, swish, pair)
    want = tgn.group_norm_backward_plain(gy, x, scale, bias, 32, 1e-5, swish, pair)
    torch.cuda.synchronize()
    for k, (g, a, w) in enumerate(zip(got, again, want)):
        if w is None:
            assert g is None and a is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, a), k
        ref = w.float().abs().max().item()
        tol = 2 ** -7 if g.dtype == torch.bfloat16 else 1e-5 if k == 0 else 1e-4
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * ref, (k, err, ref)


def test_group_norm_backward_counts_and_refusals(gen):
    """A GroupNorm's backward under autograd on the card is one call of
    ``group_norm_backward`` (one count there and one K1 launch, its moments;
    no autograd of the plain norm), asking only for the gradients the
    inputs need; the wrapper raises, and does not fall back, for gy not
    contiguous or of another dtype than x, x in fp16, or C not divisible by
    the groups."""
    gy, x, scale, bias, (fs, fb) = _gn_backward_inputs(gen, (2, 24 * 24, 1152),
                                                       torch.bfloat16, True)
    x.requires_grad_()
    for f in (fs, fb):
        f.requires_grad_()
    before = (tgn.group_norm_backward.launches, tgn.group_norm_stats.launches,
              tgn.group_norm_apply.launches)
    y = tgn.group_norm(x, scale, bias, 32, 1e-5, swish=1.0, film=(fs, fb))
    dx, dfs, dfb = torch.autograd.grad(y, (x, fs, fb), gy)
    torch.cuda.synchronize()
    after = (tgn.group_norm_backward.launches, tgn.group_norm_stats.launches,
             tgn.group_norm_apply.launches)
    assert [b - a for a, b in zip(before, after)] == [1, 2, 1]
    want = tgn.group_norm_backward_plain(gy, x.detach(), scale, bias, 32, 1e-5, 1.0,
                                         (fs.detach(), fb.detach()),
                                         (True, False, False, True, True))
    for g, w in zip((dx, dfs, dfb), (want[0], want[3], want[4])):
        assert g.shape == w.shape
        assert (g.float() - w.float()).abs().max() <= 2 ** -7 * w.float().abs().max()
    x = x.detach()
    with pytest.raises(ValueError):
        tgn.group_norm_backward(gy.transpose(0, 1).contiguous().transpose(0, 1), x,
                                scale, bias, 32, 1e-5)
    with pytest.raises(ValueError):
        tgn.group_norm_backward(gy.float(), x, scale, bias, 32, 1e-5)
    with pytest.raises(TypeError):
        tgn.group_norm_backward(gy.half(), x.half(), scale, bias, 32, 1e-5)
    with pytest.raises(ValueError):
        tgn.group_norm_backward(gy, x, scale, bias, 7, 1e-5)
    assert tgn.group_norm_backward.launches == after[0]


def test_group_norm_launches_two_kernels(gen):
    """A GroupNorm on the card is K1 + K2: at most two kernels, counted by
    the profiler, with FiLM and SiLU, with grad mode off and on."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((2, 24, 24, 768), generator=gen, device="cuda").to(torch.bfloat16)
    scale = torch.ones(768, device="cuda")
    bias = torch.zeros(768, device="cuda")
    film = torch.randn((2, 1, 1, 1536), generator=gen, device="cuda").chunk(2, dim=-1)
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            tgn.group_norm(x, scale, bias, 32, 1e-5, swish=1.0, film=film)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                tgn.group_norm(x, scale, bias, 32, 1e-5, swish=1.0, film=film)
                torch.cuda.synchronize()
        kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")
                   and not e.is_user_annotation]
        assert 1 <= len(kernels) <= 2, [e.name for e in kernels]


@pytest.mark.parametrize("B,T,S,H,d", [
    (2, 2304, 2391, 12, 64), (2, 144, 231, 24, 64), (2, 100, 187, 3, 64),
    (1, 9216, 9216, 1, 512), (1, 100, 77, 1, 512), (1, 100, 187, 1, 512),
    # the 2.0 UNet at 512² (154 text tokens before the spatial K/V), the
    # KL-VAE's mid attention
    (2, 1024, 1178, 12, 64), (2, 64, 218, 24, 64), (1, 4096, 4096, 1, 512),
    # the served 2.1 path at buckets 2 and 4
    (4, 2304, 2391, 12, 64), (8, 2304, 2391, 12, 64), (4, 144, 231, 24, 64),
    (8, 144, 231, 24, 64), (2, 9216, 9216, 1, 512), (4, 9216, 9216, 1, 512),
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


@pytest.mark.parametrize("B,T,n_tokens,H", [
    (2, 2304, 10, 12), (2, 576, 10, 20), (2, 144, 10, 24)])
def test_flash_kernel_on_the_added_kv_attention(gen, B, T, n_tokens, H):
    """K3 as the 2.2 UNet's ``AddedKVAttention`` calls it at 768²: k and v
    the concatenation [image tokens; spatial], S = T + 10 (ragged against
    the 64-row tiles), through ``added_kv_attention``, against the plain
    version and the added-KV formula."""
    from kandinsky2_tpu_torch.ops.attention import (
        added_kv_attention,
        added_kv_reference_attention,
    )

    q, k, v, ek, ev = (torch.randn((B, L, H, 64), generator=gen, device="cuda")
                       .to(torch.bfloat16) for L in (T, T, T, n_tokens, n_tokens))
    k, v = torch.cat([ek, k], dim=1), torch.cat([ev, v], dim=1)
    before = flash_attention_fwd.launches
    with torch.inference_mode():
        o = added_kv_attention(q, k, v)
    assert flash_attention_fwd.launches == before + 1
    o_ref, _ = flash_attention_plain(q, k, v)
    ref = added_kv_reference_attention(q, k, v)
    torch.cuda.synchronize()
    o_max = o_ref.float().abs().max().item()
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2 * o_max
    assert (o.float() - ref.float()).abs().max().item() <= 2e-2 * o_max


@pytest.mark.parametrize("B", [1, 2])
def test_flash_kernel_on_the_dpt_attention(gen, B):
    """K3 as DPT-Large's ViT layer calls it (``models/dpt.py``): a 384²
    image's 576 patches and the cls token, T = S = 577 (ragged against the
    64-row tiles), 16 heads of 64, through ``added_kv_attention``, against
    the plain version."""
    from kandinsky2_tpu_torch.ops.attention import added_kv_attention

    q, k, v = (torch.randn((B, 577, 16, 64), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    before = flash_attention_fwd.launches
    with torch.inference_mode():
        o = added_kv_attention(q, k, v)
    assert flash_attention_fwd.launches == before + 1
    o_ref, _ = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    o_max = o_ref.float().abs().max().item()
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2 * o_max


def test_group_norm_far_from_zero_mean_against_fp64(gen):
    """K1 + K2 in fp32 where each group's mean lies 1000 standard deviations
    from zero: within 1e-4 relative L2 of fp64 ``group_norm`` on the same
    input (the shifted sums; the one-pass form reached 5.5e-2)."""
    B, N, C = 2, 96 * 96, 384
    x = torch.randn((B, N, C), generator=gen, device="cuda") + 1000.0
    one, zero = torch.ones(C, device="cuda"), torch.zeros(C, device="cuda")
    with torch.inference_mode():
        y = tgn.group_norm(x, one, zero, 32, 1e-5)
    truth = torch.nn.functional.group_norm(
        x.double().permute(0, 2, 1), 32, eps=1e-5).permute(0, 2, 1)
    assert ((y.double() - truth).norm() / truth.norm()).item() <= 1e-4


def test_flash_kernel_reads_the_unet_q_view_in_place(gen):
    """The UNet's q is a strided view of the fused qkv projection (row
    stride 3·C, head stride 3·64): the forward reads it through its tensor
    map, as it is, and agrees with the plain version."""
    B, T, H, d = 2, 576, 18, 64
    qkv = torch.randn((B, T, H, 3 * d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.split(d, dim=-1)
    assert not q.is_contiguous()
    o, lse = flash_attention(q, k, v)
    o_ref, lse_ref = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    o_max = o_ref.float().abs().max().item()
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2 * o_max
    assert (lse - lse_ref).abs().max().item() <= 1e-3 * lse_ref.abs().max().item()


def _rel_err(got, want):
    """max |got - want| over max |want|, in fp32."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _backward_inputs(gen, B, T, S, H, d=64):
    q, k, v = (torch.randn((B, L, H, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for L in (T, S, S))
    do = torch.randn((B, T, H, d), generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = flash_attention_fwd(q, k, v)
    return q, k, v, o, lse, do


def _kernels_backward(q, k, v, o, lse, do):
    """K5 (dq and delta), then K4 (dk, dv) from that delta."""
    dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    return dq, dk, dv, delta


@pytest.mark.parametrize("B,T,S,H", [
    (1, 2304, 2391, 12), (1, 576, 663, 18), (1, 144, 231, 24), (2, 37, 50, 1),
    (1, 2304, 2314, 12), (1, 576, 586, 20), (1, 144, 154, 24),
])
def test_flash_backward_kernels_match_plain(gen, B, T, S, H):
    """K5 (dq) and K4 (dk, dv) at the 2.1 decoder training step's UNet
    shapes (d = 64, S = T + 87 encoder tokens), at the 2.2 UNet22's added-KV
    attention in LoRA and distillation at 768², batch 1 (S = T + 10 image
    tokens), and a ragged toy shape, against the fp32 plain backward from
    the same saved O and LSE.  P and dS are rounded to bf16 before their
    MMAs: 2e-2 of the largest reference gradient."""
    q, k, v, o, lse, do = _backward_inputs(gen, B, T, S, H)
    dq, dk, dv, _ = _kernels_backward(q, k, v, o, lse, do)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16, name
        assert _rel_err(got, ref) <= 2e-2, name


@pytest.mark.parametrize("B,T,S,H", [
    (1, 100, 187, 3), (2, 200, 130, 2), (1, 37, 50, 2), (2, 63, 20, 1),
    (1, 129, 64, 2), (1, 64, 129, 1), (3, 5, 300, 2),
])
def test_flash_backward_kernels_ragged(gen, B, T, S, H):
    """T and S that are not multiples of the kernels' 64- and 128-row tiles,
    T < 64 and S < 64 among them, several batches and heads: 2e-2 as above,
    and every gradient finite."""
    q, k, v, o, lse, do = _backward_inputs(gen, B, T, S, H)
    got = _kernels_backward(q, k, v, o, lse, do)[:3]
    want = flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(g.float()).all()), name
        assert _rel_err(g, w) <= 2e-2, name


def test_flash_backward_kernels_are_bitwise_repeatable(gen):
    """Every output element has one writer and a fixed order of sums (no
    atomics): dq, dk, dv and delta are bitwise equal over two calls at ds2."""
    q, k, v, o, lse, do = _backward_inputs(gen, 1, 2304, 2391, 12)
    first = _kernels_backward(q, k, v, o, lse, do)
    second = _kernels_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "delta"), first, second):
        assert torch.equal(a, b), name


def test_flash_backward_reads_strided_views_in_place(gen):
    """The UNet's q (row stride 3·C, head stride 3·64, a view of the fused
    qkv projection) and a non-contiguous dO, read through their tensor maps
    as they are, give the result of their contiguous copies."""
    B, T, H, d = 1, 576, 18, 64
    qkv = torch.randn((B, T, H, 3 * d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.split(d, dim=-1)
    do = torch.randn((B, H, T, d), generator=gen, device="cuda").to(torch.bfloat16)
    do = do.permute(0, 2, 1, 3)
    assert not q.is_contiguous() and not do.is_contiguous()
    o, lse = flash_attention_fwd(q, k, v)
    got = _kernels_backward(q, k, v, o, lse, do)
    want = _kernels_backward(*(x.contiguous() for x in (q, k, v, o)), lse, do.contiguous())
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "delta"), got, want):
        assert torch.equal(a, b), name


def test_flash_backward_delta_is_the_row_sum(gen):
    """K5's delta output against rowsum(dO·O) in fp32: the same products,
    summed in another order."""
    B, T, S, H = 1, 576, 663, 18
    q, k, v, o, lse, do = _backward_inputs(gen, B, T, S, H)
    _, delta = flash_attention_bwd_dq(q, k, v, o, do, lse)
    want = (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(B * H, T)
    torch.cuda.synchronize()
    assert delta.shape == (B * H, T) and delta.dtype == torch.float32
    assert (delta - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_functions_carry_gradients_on_the_card(gen):
    """GroupNorm and flash attention on CUDA tensors that require gradients
    give outputs with an autograd graph, and input gradients that match
    autograd of the plain versions."""
    x = torch.randn((1, 96, 96, 384), generator=gen, device="cuda").to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(384, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(384, generator=gen, device="cuda")
    fs = (0.1 * torch.randn((1, 1, 1, 384), generator=gen, device="cuda")).to(torch.bfloat16)
    fb = torch.randn((1, 1, 1, 384), generator=gen, device="cuda").to(torch.bfloat16)
    ins = [t.requires_grad_() for t in (x, scale, bias, fs, fb)]
    y = tgn.group_norm(x, scale, bias, 32, 1e-5, swish=1.0, film=(fs, fb))
    assert y.requires_grad and type(y.grad_fn).__name__ == "GroupNormFunctionBackward"
    gy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
    got = torch.autograd.grad(y, ins, gy)
    want = torch.autograd.grad(
        tgn.group_norm_plain(x, scale, bias, 32, 1e-5, swish=1.0, film=(fs, fb)), ins, gy)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel_err(g, w) <= 1e-2

    q, k, v = (torch.randn((1, L, 12, 64), generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_() for L in (2304, 2391, 2391))
    o = flash_attention(q, k, v)[0]
    assert o.requires_grad and type(o.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    go = torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype)
    got = torch.autograd.grad(o, (q, k, v), go)
    want = torch.autograd.grad(flash_attention_plain(q, k, v)[0], (q, k, v), go)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel_err(g, w) <= 2e-2


def test_fp32_unet_and_movq_on_the_card_match_the_cpu(gen):
    """fp32 models run on the card (their attention routed to the reference
    semantics, every GroupNorm on K1 + K2 in fp32) and match the same
    models on the CPU at 1e-4 relative L2, with TF32 off: the small-width
    UNet (32-wide heads) and the MoVQ decoder and encoder."""
    from kandinsky2_tpu_torch.configs import create_model, small_config
    from kandinsky2_tpu_torch.models.movq import MOVQ
    from kandinsky2_tpu_torch.pipelines.base import init_random_

    cfg = small_config()
    dd = cfg["image_enc_params"]["params"]["ddconfig"]
    movq_kw = dict(n_embed=64, ch=dd["ch"], ch_mult=tuple(dd["ch_mult"]),
                   num_res_blocks=dd["num_res_blocks"],
                   attn_resolutions=tuple(dd["attn_resolutions"]),
                   resolution=dd["resolution"])
    mc = cfg["model_config"]
    cpu_gen = torch.Generator().manual_seed(0)
    models = {}
    for name, make in (("unet", lambda dev: create_model(**mc, dtype=torch.float32,
                                                         device=dev)),
                       ("movq", lambda dev: MOVQ(**movq_kw, device=dev))):
        cpu = make("cpu")
        init_random_(cpu, cpu_gen)
        card = make("cuda")
        card.load_state_dict(cpu.state_dict())
        models[name] = (cpu, card)
    r = lambda *shape: torch.randn(shape, generator=cpu_gen)
    cases = {
        "unet": (lambda m: m, (r(2, 8, 8, 4), torch.tensor([981.0, 11.0]),
                               r(2, 6, mc["text_encoder_in_dim1"]),
                               r(2, mc["text_encoder_in_dim2"]),
                               r(2, mc["image_encoder_in_dim"]))),
        "movq": (lambda m: m.decode, (r(1, 8, 8, 4),)),
        "movq.encode": (lambda m: m.encode, (torch.tanh(r(1, 64, 64, 3)),)),
    }
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            for name, (get, args) in cases.items():
                cpu, card = models[name.split(".")[0]]
                want = get(cpu)(*args)
                got = get(card)(*(a.cuda() for a in args)).cpu()
                assert got.dtype == torch.float32
                rel = ((got - want).norm() / want.norm()).item()
                assert rel <= 1e-4, (name, rel)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def test_group_norm_on_two_streams_at_once(gen):
    """GroupNorms of two shapes on two streams at once, many times: each
    stream has its own K1 counters, so every output matches the plain
    version."""
    shapes = [(2, 24 * 24, 1152), (1, 96 * 96, 512)]
    xs = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in shapes]
    params = [(1 + 0.1 * torch.randn(s[-1], generator=gen, device="cuda"),
               0.1 * torch.randn(s[-1], generator=gen, device="cuda")) for s in shapes]
    wants = [tgn.group_norm_plain(x, sc, b, 32, 1e-5, swish=1.0)
             for x, (sc, b) in zip(xs, params)]
    streams = [torch.cuda.Stream() for _ in shapes]
    torch.cuda.synchronize()
    outs = [[], []]
    with torch.inference_mode():
        for _ in range(50):
            for i, (x, (sc, b), st) in enumerate(zip(xs, params, streams)):
                with torch.cuda.stream(st):
                    outs[i].append(tgn.group_norm(x, sc, b, 32, 1e-5, swish=1.0))
    torch.cuda.synchronize()
    for want, got in zip(wants, outs):
        ref = max(1.0, want.float().abs().max().item())
        for y in got:
            assert (y.float() - want.float()).abs().max().item() <= 2 ** -7 * ref
