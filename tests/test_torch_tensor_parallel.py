"""Tensor-parallel inference in the port (``parallel.make_mesh``, the
sharding rule and its audit, ``shard_params`` and ``pipe.shard()``) on the
CPU in fp32, over one pool of four gloo ranks (``torch_tp_ranks``, the rank
side, which imports no JAX):

* (a) ``_param_spec`` on the JAX tests' cases (``tests/test_parallel.py``),
  ``make_mesh``'s shapes and its halving rule, and the coverage guard;
* (b) ``audit_sharding`` of the full-size models built on the meta device
  against JAX's on ``jax.eval_shape`` trees (``tests/test_sharding_audit.py``'s
  tree functions): every parameter's spec and every ``ShardingReport`` field at
  model-parallel 2, 4 and 8 for the 2.1 UNet, the 2.1 prior and the 2.2
  UNet; JAX's own assertions for the 2.2 prior and ViT-bigG;
* (c) the column-, row- and embedding-sharded layers at 2 and 4 ranks
  within 1e-6 of the unsharded layer, the bias counted once;
* (d) text2img of the tiny 2.1, 2.2 and 2.0 pipelines after
  ``shard(model_parallel=4, min_size=64)`` and on (data 2, model 2): the
  latents and the image within ``SHARD_TOL`` of the port unsharded (bit
  for bit with the row-parallel specs left out) and within ``E2E_TOL`` of
  the JAX pipeline on the same parameters and noise;
  ``pipe.sharding_report`` equal to JAX's ``shard()`` report at the same
  ``min_size``; ``sp_mesh=`` on a sharded pipeline refused;
* (e) JAX's serving test on the sharded tiny 2.1 pipeline, and a LoRA
  request matching the unsharded server's.

The ranks' runs are driven from a thread, so they go on while this one
builds the JAX pipelines, runs them and audits.
"""

import functools
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import test_sharding_audit as jaudit_trees
import torch_tp_ranks as ranks
from kandinsky2_tpu.parallel import make_mesh as jax_make_mesh
from kandinsky2_tpu.parallel import mesh as jmesh
from kandinsky2_tpu_torch.parallel.launch import RankPool
from kandinsky2_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    P,
    ShardingReport,
    _param_spec,
    audit_sharding,
    param_specs,
)
from kandinsky2_tpu_torch.weights.from_jax import flatten, plan
from test_torch_common import (
    assert_close,
    assert_images,
    capture_jax_floats,
    capture_jax_floats20,
    capture_jax_floats22,
    shared_pair,
    small_config,
    tiny22,
    tiny_config20,
)

MESHES = ((1, 4), (2, 2))  # (data, model)
SERVE_KW = dict(num_steps=4, h=64, w=64, sampler="ddim_sampler", prior_steps="3")
RANK_TIMEOUT = 900  # s, a ranks' run's result (each run has its own deadline)
# The port sharded against the port unsharded, fp32.  Column-parallel
# layers reorder no sum, so with the row-parallel specs left out the
# sharded pipelines are the unsharded ones bit for bit (the "columns" run).
# A row-parallel layer adds its ranks' partial sums, a reassociation at
# fp32's rounding that these random tiny pipelines magnify: sharding only
# the 2.1 zero image's CLIP tower moves that embedding by 2.4e-7, the
# latents (|z| up to 58) by 1.2e-6 and the image by 2.2e-5 (relative L2);
# with every model sharded the 2.1 image moves by up to 6.0e-5 and the 2.2
# latents by 4.6e-5 of their largest values, so the row-sharded tests'
# limit holds, not 1e-5.
SHARD_TOL = 1e-4
LAYER_TOL = 1e-6


# --- the two sides ---------------------------------------------------


def _kw(version):
    """text2img arguments with every draw given (fp32, 64², few steps)."""
    rng = np.random.RandomState(3)
    noise = rng.randn(1, 8, 8, 4).astype(np.float32)
    if version == "2.1":
        return dict(prompt="a cat", num_steps=4, h=64, w=64, sampler="ddim_sampler",
                    prior_steps="3", noise=noise,
                    prior_noise=rng.randn(1, 64).astype(np.float32),
                    prior_noise_seq=rng.randn(3, 1, 64).astype(np.float32))
    if version == "2.2":
        return dict(prompt="a cat", decoder_steps=3, prior_steps=3, h=64, w=64,
                    noise=noise, noise_seq=rng.randn(3, 1, 8, 8, 4).astype(np.float32),
                    prior_noise=rng.randn(1, 32).astype(np.float32),
                    prior_noise_seq=rng.randn(3, 1, 32).astype(np.float32))
    return dict(prompt="a cat", num_steps=4, h=64, w=64, ddim_eta=0.0, noise=noise)


def _spec(version, tp):
    if version == "2.1":
        return {"version": version, "config": small_config(),
                "clip": (np.asarray(tp.clip_mean.cpu()).reshape(-1),
                         np.asarray(tp.clip_std.cpu()).reshape(-1))}
    return {"version": version, "config": tiny22() if version == "2.2" else tiny_config20(),
            "clip": None}


def _jax_report(params, model_parallel):
    """JAX's ``shard()`` report for ``params`` on 4 of its CPU devices."""
    ns = types.SimpleNamespace(params=params)
    jmesh.shard_pipeline(ns, mesh=jax_make_mesh(4, model_parallel=model_parallel),
                         min_size=64, verbose=False)
    return ns.sharding_report


@pytest.fixture(scope="module", autouse=True)
def side():
    """The ranks' runs ({case: future of the ranks' results}), driven from
    a thread, each as soon as its pipeline's parameters are built here, so
    that the ranks work while this thread runs the audit and the JAX
    pipelines."""
    mp = pytest.MonkeyPatch()
    for capture in (capture_jax_floats, capture_jax_floats22, capture_jax_floats20):
        capture(mp)
    rank_ex = ThreadPoolExecutor(1)
    pool = RankPool(4, device="cpu", init_timeout=300)
    try:
        runs = {"meshes": rank_ex.submit(pool.run, ranks.meshes),
                "guard": rank_ex.submit(pool.run, ranks.coverage_guard),
                **{("layers", m): rank_ex.submit(pool.run, ranks.layers, m, 7)
                   for m in (2, 4)}}
        for v in ("2.1", "2.2", "2.0"):
            _, tp, params = shared_pair(v)
            runs[v] = rank_ex.submit(pool.run, ranks.text2img_all,
                                     {v: (_spec(v, tp), params, _kw(v))}, MESHES,
                                     timeout=RANK_TIMEOUT)
        _, tp, params = shared_pair("2.1")
        runs["serve"] = rank_ex.submit(pool.run, ranks.serve, _spec("2.1", tp), params,
                                       SERVE_KW, 5, 9, timeout=RANK_TIMEOUT)
        yield types.SimpleNamespace(runs=runs)
    finally:
        rank_ex.shutdown(wait=True)
        pool.close()
        mp.undo()


@functools.lru_cache(maxsize=None)
def _jax_reference(version):
    """JAX's float images of text2img and its ``shard()`` reports (the
    shared pipeline's key restored after the call)."""
    jp, _, params = shared_pair(version)
    key = jp._rng
    try:
        want = jp.generate_text2img(**_kw(version))
    finally:
        jp._rng = key
    return want, {shape: _jax_report(params, shape[1]) for shape in MESHES}


# --- (a) the rule, the mesh, the guard ---------------------------------------------


def test_param_spec_rules():
    """JAX's cases (tests/test_parallel.py), and the port's rule equal to
    JAX's on them and on the 4-D and embedding cases."""
    big_qkv = np.zeros((1024, 3072))
    assert _param_spec(("a", "qkv", "kernel"), big_qkv) == P(None, MODEL_AXIS)
    proj = np.zeros((2048, 1024))
    assert _param_spec(("a", "proj_out", "kernel"), proj) == P(MODEL_AXIS, None)
    assert _param_spec(("a", "qkv", "kernel"), np.zeros((64, 64))) == P()
    assert _param_spec(("a", "norm", "scale"), np.zeros((1024,))) == P()
    cases = [(("a", "qkv", "kernel"), (1024, 3072)),
             (("a", "proj_out", "kernel"), (2048, 1024)),
             (("out.2", "kernel"), (3, 3, 1024, 8)),
             (("b", "c_proj", "kernel"), (3, 3, 1024, 2048)),
             (("emb", "embedding"), (49408, 1280)), (("x", "fc2", "kernel"), (512, 4096)),
             (("x", "bias"), (4096,))]
    for path, shape in cases:
        arr = np.zeros(shape, np.float32)
        assert tuple(_param_spec(path, arr)) == tuple(jmesh._param_spec(path, arr)), path


# --- (b) the audit of the full-size models --------------------------------------------


@pytest.fixture(scope="module")
def fullsize():
    """The port's full-size models on the meta device: the 2.1 UNet and
    prior at ``CONFIG_2_1``, the 2.2 models at the published configuration."""
    from kandinsky2_tpu_torch.configs import CONFIG_2_1, create_model
    from kandinsky2_tpu_torch.models.prior import PriorTransformer
    from kandinsky2_tpu_torch.models.prior22 import PriorTransformer22
    from kandinsky2_tpu_torch.models.text_encoders import HFCLIPVision
    from kandinsky2_tpu_torch.models.unet22 import UNet22
    from kandinsky2_tpu_torch.weights import configs22

    hp = {k: v for k, v in CONFIG_2_1["prior"]["params"]["model"]["hparams"].items()
          if k in ("text_ctx", "xf_width", "xf_layers", "xf_heads", "xf_final_ln",
                   "clip_dim", "clip_xf_width")}
    ov = configs22.pipeline_overrides(task_type="text2img")
    return {"unet21": create_model(**dict(CONFIG_2_1["model_config"], inpainting=False),
                                   device="meta"),
            "prior21": PriorTransformer(**hp, device="meta"),
            "unet22": UNet22(**ov["unet"], device="meta"),
            "prior22": PriorTransformer22(**ov["prior"], device="meta"),
            "vit_bigg": HFCLIPVision(**ov["image_encoder"], device="meta")}


# JAX's audit at model-parallel 4: sharded and replicated params, then
# sharded, candidate and total bytes
AUDIT4 = {"unet21": (140, 454, 4_261_478_400, 4_508_811_264, 4_914_647_072),
          "prior21": (86, 170, 4_085_252_096, 4_085_252_096, 4_088_114_176),
          "unet22": (170, 554, 4_499_439_616, 4_747_558_912, 5_236_039_200)}
# a JAX leaf's dim -> the port's dim, by the bridge's transform
_TO_TORCH = {"hwio": (2, 3, 1, 0), "io": (1, 0), "io1": (1, 0), "io11": (1, 0)}


@pytest.mark.parametrize("name", sorted(AUDIT4))
def test_audit_matches_jax_per_parameter(fullsize, name):
    shapes = jaudit_trees.TREES[name][0]()
    module = fullsize[name]
    bridge = plan(shapes, {k: tuple(v.shape) for k, v in module.state_dict().items()})
    flat = flatten(shapes)
    for mp in (2, 4, 8):
        want_rep = jmesh.ShardingReport()
        want = {}
        for key, (path, op) in bridge.items():
            spec = jmesh._account_spec(path, flat[path], {"data": 1, "model": mp}, 1024,
                                       want_rep)
            dims = [i for i, ax in enumerate(spec) if ax is not None]
            want[key] = _TO_TORCH.get(op, range(8))[dims[0]] if dims else None
        got_rep = ShardingReport()
        got = param_specs(module, mp, 1024, got_rep)
        assert got == want, (name, mp, sorted(k for k in got if got[k] != want[k])[:5])
        assert _fields(got_rep) == _fields(want_rep), (name, mp)
        assert _fields(audit_sharding(module, mp, 1024)) == _fields(want_rep), (name, mp)
        if mp == 4:
            assert (got_rep.sharded_params, got_rep.replicated_params,
                    got_rep.sharded_bytes, got_rep.candidate_bytes,
                    got_rep.total_bytes) == AUDIT4[name]
            assert not got_rep.fallbacks


@pytest.mark.parametrize("name", ["prior22", "vit_bigg"])
def test_audit_fullsize_coverage(fullsize, name):
    """JAX's assertions (tests/test_sharding_audit.py) on the port's audit."""
    module = fullsize[name]
    n_params = sum(p.numel() for p in module.parameters())
    assert n_params >= jaudit_trees.TREES[name][1], (name, n_params)
    for mp in jaudit_trees.MODEL_PARALLEL:
        rep = audit_sharding(module, model_parallel=mp, min_size=1024)
        assert not rep.fallbacks, (name, mp, rep.fallbacks[:6])
        assert rep.candidate_frac >= 0.9, (name, mp, rep.summary())


def test_make_mesh_shapes(side):
    """(data, model) shapes, the model axis the fast one, the halving rule,
    a sub-mesh of chosen ranks (None on the others)."""
    res = side.runs["meshes"].result(timeout=RANK_TIMEOUT)
    for rank, got in enumerate(res):
        assert got["default"] == ((1, 4), (0, rank), (0, 1, 2, 3))
        assert got["mp 8 halves to 4"] == got["default"]
        assert got["mp 2"] == ((2, 2), divmod(rank, 2), (0, 1) if rank < 2 else (2, 3))
        assert got["mp 3 halves to 1"] == ((4, 1), (rank, 0), (rank,))
        assert got["first 2"] == (((1, 2), (0, rank), (0, 1)) if rank < 2 else None)
        assert got["ranks 1, 3"] == (((1, 2), (0, rank // 2), (1, 3)) if rank % 2 else None)


def test_sharding_coverage_guard_raises(side):
    """JAX's guard test: a large kernel whose dims the model axis does not
    divide falls back to replication, and ``min_candidate_frac`` raises."""
    rep, err = side.runs["guard"].result(timeout=RANK_TIMEOUT)[0]
    assert rep["candidate_bytes"] > 0 and rep["sharded_bytes"] == 0
    assert rep["fallbacks"] == [("layer.qkv/kernel", (258, 2050))]
    assert err is not None and "coverage too low" in err


# --- (c) the sharded layers ----------------------------------------------------------


@pytest.mark.parametrize("mp", [2, 4])
def test_sharded_layers_match_unsharded(side, mp):
    """Each sharded form within ``LAYER_TOL`` of the layer unsharded (of the
    larger of 1 and the output's largest value; the biases ~ N(0, 0.1²):
    a bias added once per rank would miss by far more), the weight cut to
    its rank's slice and gathered whole again by ``full_weight``."""
    res = side.runs["layers", mp].result(timeout=RANK_TIMEOUT)[0]
    assert len(res) == 7
    for name, (err, scale, _, _, regathered) in res.items():
        assert err <= LAYER_TOL * max(1.0, scale), (name, err)
        assert regathered, name
    assert res["row conv 1x1 stride 2"][2] == (2, 3, 3, 32)
    # the weight keeps 1/mp of the sharded dim
    assert res["column linear"][3] == (64 // mp, 48)
    assert res["row linear"][3] == (64, 48 // mp)
    assert res["column conv"][3] == (32 // mp, 48, 3, 3)
    assert res["row conv"][3] == (32, 48 // mp, 3, 3)
    assert res["column embedding"][3] == (64, 32 // mp)
    assert res["row embedding"][3] == (64 // mp, 32)


# --- (d) the pipelines ---------------------------------------------------------------


def _fields(rep):
    """A report's fields (a ``ShardingReport`` of either package, or the
    ranks' dict of one), its fallbacks' names with JAX's ``/`` as dots."""
    if isinstance(rep, dict):
        rep = ShardingReport(rep["sharded_params"], rep["replicated_params"],
                             rep["sharded_bytes"], rep["total_bytes"],
                             rep["candidate_bytes"], rep["fallbacks"])
    return (rep.sharded_params, rep.replicated_params, rep.sharded_bytes, rep.total_bytes,
            rep.candidate_bytes, [(n.replace("/", "."), tuple(s)) for n, s in rep.fallbacks],
            rep.summary(), rep.candidate_frac >= 0.5)


@pytest.mark.parametrize("version", ["2.1", "2.2", "2.0"])
def test_sharded_text2img(side, version):
    want, jax_reports = _jax_reference(version)
    runs = [r[version] for r in side.runs[version].result(timeout=RANK_TIMEOUT)]
    whole = runs[0]["whole"]
    assert np.std(whole[1]) > 1e-3
    for res in runs:
        lat, img, n_sharded = res["columns"]
        assert n_sharded > 0
        np.testing.assert_array_equal(lat, whole[0])
        np.testing.assert_array_equal(img, whole[1])
    for shape in MESHES:
        for rank, res in enumerate(runs):
            lat, img, rep, counts, refused = res[shape]
            what = f"{version} {shape} rank {rank}"
            assert_close(lat, whole[0], SHARD_TOL, what + " latents")
            assert_close(img, whole[1], SHARD_TOL, what + " image")
            assert_images(img, want, what + " against JAX")
            assert counts["all_gather"] > 0 and counts["psum"] > 0, what
            assert "do not compose" in refused, what
            assert _fields(rep) == _fields(jax_reports[shape]), what
            assert _fields(rep)[-1], what  # shard()'s own guard held


# --- (e) serving ----------------------------------------------------------------------


def test_serving_over_sharded_pipeline(side):
    """Two prompts at ``max_batch=2`` on the sharded tiny 2.1 pipeline, each
    a finite 64² image on every rank; then a LoRA request (on ``qkv``,
    column-sharded, and ``proj_out``, row-sharded), the same on every rank
    and as the unsharded server's."""
    res = side.runs["serve"].result(timeout=RANK_TIMEOUT)
    whole = res[0][2]
    assert np.std(whole) > 1e-3
    for rank, (imgs, got, _, stats, targets) in enumerate(res):
        assert any("qkv" in k for k in targets) and any("proj_out" in k for k in targets)
        assert len(imgs) == 2, rank
        for img in imgs:
            assert img.shape == (64, 64, 3) and np.isfinite(img).all(), rank
        assert stats["requests"] == 3 and stats["errors"] == 0, (rank, stats)
        assert_close(got, whole, SHARD_TOL, f"LoRA request rank {rank}")
        assert_close(got, res[0][1], 0.0, f"LoRA request rank {rank} against rank 0")
