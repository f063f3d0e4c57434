"""The port's GroupNorm pair (K1 statistics + K2 apply, ``kandinsky2_tpu_torch/
ops/group_norm.py``) against the JAX package's Pallas kernels in interpret
mode and its plain XLA reference: the whole norm in fp32 at 1e-4, K1's
coefficients at 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kandinsky2_tpu.models import layers as jax_layers
from kandinsky2_tpu.ops import group_norm as jgn
from kandinsky2_tpu.ops.group_norm import _xla_reference, pallas_group_norm
from kandinsky2_tpu_torch.models.layers import GroupNorm32
from kandinsky2_tpu_torch.ops import group_norm as tgn
from test_torch_common import MODULE_TOL, assert_close, numpy_params


def _inputs(seed, shape=(2, 6, 8, 128), film=False):
    rng = np.random.RandomState(seed)
    C = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.7).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    fpair = None
    if film:
        fpair = ((0.3 * rng.randn(shape[0], C)).astype(np.float32),
                 rng.randn(shape[0], C).astype(np.float32))
    return x, scale, bias, fpair


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("swish", [0.0, 1.0])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm_matches_pallas_and_xla(film, swish, eps):
    x, scale, bias, fpair = _inputs(0, film=film)
    jf = None if fpair is None else tuple(jnp.asarray(f) for f in fpair)
    pallas = pallas_group_norm(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(bias), 32, eps, swish=swish,
                               film=jf, interpret=True)
    xla = _xla_reference(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                         None if jf is None else jf[0],
                         None if jf is None else jf[1], 32, eps, swish)
    tf = None if fpair is None else tuple(torch.from_numpy(f) for f in fpair)
    got = tgn.group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                         torch.from_numpy(bias), 32, eps, swish=swish, film=tf)
    assert got.dtype == torch.float32
    assert_close(got, pallas, MODULE_TOL, "vs pallas interpret")
    assert_close(got, xla, MODULE_TOL, "vs xla reference")


def test_moments_and_apply_plain_pieces():
    """K1's plain moments and K2 separately: per-channel sums and the fused
    multiply-add."""
    x, _, _, _ = _inputs(1, shape=(2, 40, 96))
    s1, s2 = tgn.group_norm_moments_plain(torch.from_numpy(x))
    np.testing.assert_allclose(s1.numpy(), x.sum(1), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), (x * x).sum(1), rtol=1e-5, atol=1e-3)
    a = np.random.RandomState(2).randn(2, 96).astype(np.float32)
    b = np.random.RandomState(3).randn(2, 96).astype(np.float32)
    y = tgn.group_norm_apply(torch.from_numpy(x), torch.from_numpy(a),
                             torch.from_numpy(b), 1.0)
    z = x * a[:, None] + b[:, None]
    np.testing.assert_allclose(y.numpy(), z / (1 + np.exp(-z)), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("film", [False, True])
def test_group_norm_stats_matches_pallas_moments_and_coefficients(dtype, film):
    """K1's function (``group_norm_stats`` on a CPU tensor, its plain
    version) against the JAX package's ``_moments`` Pallas kernel in
    interpret mode followed by its ``_coefficients`` glue: the per-(b, c)
    coefficients a and b, from bf16 or fp32 x, at 1e-5 of the largest."""
    x, scale, bias, fpair = _inputs(7, shape=(2, 24, 128), film=film)
    # bf16 inputs are rounded once, then given exactly to both frameworks
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    B, N, C = x.shape
    s1, s2 = jgn._moments(xj, jgn._pick_tn(N, C, xj.dtype.itemsize), True)
    fs, fb = (None, None) if fpair is None else (jnp.asarray(f) for f in fpair)
    want = jgn._coefficients(s1, s2, jnp.float32(N * (C // 32)), jnp.asarray(scale),
                             jnp.asarray(bias), fs, fb, 32, 1e-5)
    tf = None if fpair is None else tuple(torch.from_numpy(f) for f in fpair)
    got = tgn.group_norm_stats(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                               tf, 32, 1e-5)
    for name, g, w in zip("ab", got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), f"{name}: {err:.3e}"


def test_any_channel_count_divisible_by_groups():
    """C % 128 was a TPU tiling rule: the port takes C = 96 or 4 * 32 + 32."""
    for C in (96, 160):
        x, scale, bias, _ = _inputs(4, shape=(1, 5, 7, C))
        want = _xla_reference(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias), None, None, 32, 1e-5, 1.0)
        got = tgn.group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias), 32, 1e-5, swish=1.0)
        assert_close(got, want, MODULE_TOL, f"C={C}")


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((1, 8, 64), device="meta")
    with pytest.raises(RuntimeError):
        tgn.group_norm_stats(x, x[0, 0], x[0, 0], None, 32, 1e-5)
    with pytest.raises(RuntimeError):
        tgn.group_norm_apply(x, x[:, 0], x[:, 0], 0.0)


@pytest.fixture
def pallas_norm():
    before = jax_layers._NORM_IMPL
    jax_layers.set_norm_impl("pallas")
    yield
    jax_layers.set_norm_impl(before)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_groupnorm32_module_matches_jax_pallas_route(pallas_norm, eps):
    import jax

    x, _, _, fpair = _inputs(5, film=True)
    jm = jax_layers.GroupNorm32(num_groups=32, eps=eps, swish=1.0)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 6)
    fs = fpair[0][:, None, None, :]
    fb = fpair[1][:, None, None, :]
    want = jm.apply(params, jnp.asarray(x), film=(jnp.asarray(fs), jnp.asarray(fb)))
    tm = GroupNorm32(128, eps=eps, swish=1.0)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.asarray(params["params"]["scale"])))
        tm.bias.copy_(torch.from_numpy(np.asarray(params["params"]["bias"])))
        got = tm(torch.from_numpy(x), film=(torch.from_numpy(fs), torch.from_numpy(fb)))
    assert_close(got, want, MODULE_TOL, "GroupNorm32")

