"""The port's GroupNorm pair (K1 statistics + K2 apply, ``kandinsky2_tpu_torch/
ops/group_norm.py``) against the JAX package's Pallas kernels in interpret
mode and its plain XLA reference: the whole norm in fp32 at 1e-4, K1's
coefficients at 1e-5, K2 at 1e-6; and the two kernels' launch plan."""

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
    """K1's plain moments and K2 separately: per-channel sums less each
    group's pivot (its first channel at row 0), and the fused
    multiply-add."""
    x, _, _, _ = _inputs(1, shape=(2, 40, 96))
    p, s1, s2 = tgn.group_norm_moments_plain(torch.from_numpy(x), 32)
    np.testing.assert_array_equal(p.numpy(), x[:, 0, ::3])
    d = x - np.repeat(x[:, 0, ::3], 3, axis=-1)[:, None]
    np.testing.assert_allclose(s1.numpy(), d.sum(1), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), (d * d).sum(1), rtol=1e-5, atol=1e-3)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("swish", [0.0, 1.0, 0.5])
def test_group_norm_apply_matches_pallas_apply(dtype, swish):
    """K2's function (``group_norm_apply`` on a CPU tensor, its plain
    version) against the JAX package's ``_apply`` Pallas kernel in
    interpret mode, for any swish: 1e-6 of the largest value in fp32, one
    bf16 step of the largest value in bf16."""
    rng = np.random.RandomState(11)
    B, N, C = 2, 24, 128
    x = (rng.randn(B, N, C) * 2 + 0.3).astype(np.float32)
    a = (1 + 0.5 * rng.randn(B, C)).astype(np.float32)
    b = rng.randn(B, C).astype(np.float32)
    # bf16 inputs are rounded once, then given exactly to both frameworks
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    want = jgn._apply(xj, jnp.asarray(a), jnp.asarray(b), swish,
                      jgn._pick_tn(N, C, xj.dtype.itemsize), True)
    got = tgn.group_norm_apply(xt, torch.from_numpy(a), torch.from_numpy(b), swish)
    assert got.dtype == xt.dtype and got.shape == (B, N, C)
    want = np.asarray(want).astype(np.float32)
    err = np.abs(got.float().numpy() - want).max()
    tol = (1e-6 if dtype == "float32" else 2.0 ** -7) * np.abs(want).max()
    assert err <= tol, f"{err:.3e} > {tol:.3e}"


def _rows_once(ranges, N):
    """Whether the row ranges [r0, r1, step) cover 0..N-1 exactly once."""
    count = np.zeros(N, np.int64)
    for r0, r1, step in ranges:
        count[r0:r1:step] += 1
    return bool((count == 1).all())


@pytest.mark.parametrize("shape,dtype,offset", [
    ((2, 96 * 96, 384), torch.bfloat16, 0), ((2, 48 * 48, 768), torch.bfloat16, 0),
    ((2, 24 * 24, 1152), torch.bfloat16, 0), ((2, 12 * 12, 3072), torch.bfloat16, 0),
    ((2, 96 * 96, 384), torch.float32, 0), ((1, 96 * 96, 512), torch.bfloat16, 0),
    ((1, 768 * 768, 128), torch.bfloat16, 0), ((2, 1999, 384), torch.bfloat16, 0),
    ((3, 1999, 96), torch.bfloat16, 0), ((2, 37, 160), torch.float32, 0),
    ((2, 1999, 384), torch.bfloat16, 2), ((2, 144, 1152), torch.float32, 2),
    ((1, 5, 160), torch.bfloat16, 2),
])
def test_launch_plan_covers_every_element_once(shape, dtype, offset):
    """Both kernels' grids, from ``launch_plan`` (pure Python) with the index
    math of csrc/group_norm.cu: every row of every batch once, every channel
    once by the C / vec chunks of a row (K2: by its strips of them), within
    the launch limits (1024 threads a block, 227 KB of shared memory, 65535
    blocks in y, 2^31 - 1 in x) and, for K2, the blocks' row counts at most
    one apart, each thread's rows in one pass of its loads, and the blocks
    an SM should get where the rows allow, on 132, 114 and 16 SMs.  At the path's shapes, a ragged
    N, C = 96 and 160, and a pointer two elements past 16 bytes, which
    narrows the loads."""
    B, N, C = shape
    x = torch.empty(B * N * C + offset, dtype=dtype)[offset:]
    vec = tgn.vec_width(C, x.data_ptr(), x.element_size())
    assert vec * x.element_size() <= 16 and C % vec == 0
    assert offset == 0 or vec == 2
    chunks = C // vec
    assert 0 < chunks <= 1024
    for sms in (132, 114, 16):
        p = tgn.launch_plan(B, N, C, vec, sms)
        # K1: block s sums rows [s rows, (s + 1) rows) of whole rows, thread
        # row t every ty, with (2 ty C + 2 G) floats of shared memory
        assert p.stats_threads <= 1024 and p.stats_threads % chunks == 0
        ty = p.stats_threads // chunks
        assert B <= 65535 and (2 * ty * C + 2 * 32) * 4 <= 227 * 1024
        assert p.stats_rows % (ty * tgn._STATS_UNROLL) == 0
        assert (p.stats_splits - 1) * p.stats_rows < N <= p.stats_splits * p.stats_rows
        assert _rows_once([(s * p.stats_rows + t, min(N, (s + 1) * p.stats_rows), ty)
                           for s in range(p.stats_splits) for t in range(ty)], N)
        # K2: block (k, strip) takes rows [k N / s, (k + 1) N / s) of the
        # strip's cw chunks, thread row t every ty: at most _APPLY_UNROLL rows
        # a thread, and _APPLY_BLOCKS_PER_SM blocks an SM where there are
        # that many row groups
        cw = p.apply_cw
        assert chunks % cw == 0 and p.apply_threads % cw == 0 and p.apply_threads <= 1024
        ty, s, strips = p.apply_threads // cw, p.apply_splits, chunks // cw
        assert cw == chunks or cw >= 8
        assert s * strips < 2**31
        counts = {(k + 1) * N // s - k * N // s for k in range(s)}
        assert max(counts) - min(counts) <= 1 and min(counts) >= 1
        assert max(counts) <= tgn._APPLY_UNROLL * ty
        assert s >= min(-(-N // ty), -(-sms * tgn._APPLY_BLOCKS_PER_SM // (B * strips)))
        assert _rows_once([(k * N // s + t, (k + 1) * N // s, ty)
                           for k in range(s) for t in range(ty)], N)
        cols = np.zeros(C, np.int64)
        for strip in range(strips):
            for tx in range(cw):
                c = (strip * cw + tx) * vec
                cols[c:c + vec] += 1
        assert (cols == 1).all()


def test_plan_struct_mirrors_the_cuda_source():
    """``_Plan`` has ``Plan``'s fields of csrc/group_norm.cu in its order and
    C types, and the Python copies of the kernels' constants have the
    source's values (on the card ``_lib`` checks the same against the built
    library's offsets)."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(tgn.__file__).parents[1] / "csrc" / "group_norm.cu").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    ctype = {"long long": ctypes.c_longlong, "double": ctypes.c_double,
             "void*": ctypes.c_void_p}
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        if decl.strip():
            kind, names = re.match(r"\s*(long long|double|void\*)\s+(.*)", decl, re.S).groups()
            fields += [(n.strip(), ctype[kind]) for n in names.split(",")]
    assert [(n, t) for n, t in tgn._Plan._fields_] == fields
    const = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["UNROLL"], const["APPLY_UNROLL"], const["MAX_THREADS"]) == (
        tgn._STATS_UNROLL, tgn._APPLY_UNROLL, tgn._MAX_CHUNKS)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((1, 8, 64), device="meta")
    with pytest.raises(RuntimeError):
        tgn.group_norm_stats(x, x[0, 0], x[0, 0], None, 32, 1e-5)
    with pytest.raises(RuntimeError):
        tgn.group_norm_apply(x, x[:, 0], x[:, 0], 0.0)
    for grad in (False, True):
        with torch.set_grad_enabled(grad), pytest.raises(RuntimeError):
            tgn.group_norm(x, x[0, 0], x[0, 0], 32, 1e-5)


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



@pytest.mark.parametrize("mean_over_std", [1, 10, 100, 1000])
def test_plain_group_norm_holds_far_from_zero_mean(mean_over_std):
    """The plain GroupNorm (the CPU route, the backward's recompute and K1's
    plain version) against fp64 ``torch.nn.functional.group_norm`` on the
    same fp32 input, where every group's mean lies ``mean_over_std``
    standard deviations from zero: within 1e-4 relative L2.  The shifted
    sums keep it there; the one-pass E[x²] − mean² reached 5.5e-2 at
    1000."""
    B, N, C = 2, 48 * 48, 384
    rng = np.random.RandomState(mean_over_std)
    x = (rng.randn(B, N, C) * 0.5 + 0.5 * mean_over_std).astype(np.float32)
    xt = torch.from_numpy(x)
    got = tgn.group_norm_plain(xt, torch.ones(C), torch.zeros(C), 32, 1e-5)
    truth = torch.nn.functional.group_norm(
        xt.double().permute(0, 2, 1), 32, eps=1e-5).permute(0, 2, 1)
    rel = ((got.double() - truth).norm() / truth.norm()).item()
    assert rel <= 1e-4, f"mean/std {mean_over_std}: rel_l2 {rel:.3e}"
