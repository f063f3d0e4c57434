"""ZeRO-3 (FSDP) training of the 2.1 decoder in the port against the JAX
package, on the CPU in fp32.

The port runs one process per rank: one pool of four gloo ranks on loopback
(``torch_fsdp_ranks``, the rank side) serves every case; the JAX side runs
in this process on the virtual devices of ``tests/conftest.py``, its
unsharded steps traced and compiled on a thread of their own while the
ranks run the cases before them.  Held here:

* ``_fsdp_augment`` word for word, and the placement of
  ``fsdp_state_shardings`` for every parameter and EMA leaf of the
  full-size CONFIG_2_1 UNet (meta device) against JAX's on ``jax.eval_shape``
  trees, with and without ``tp``;
* Adafactor on slices cut on a factored tensor's d0 and on its d1 (and a
  vector, beside a whole tensor), with clipping, parameter scale and
  momentum, against ``optax.adafactor`` on the whole tensors;
* two steps of ``make_fsdp_train_fn`` (AdamW, EMA, the loss-aware sampler)
  on (data 4), on (data 2, model 2) with ``tp``, and with ``accum_steps=2``
  on (data 2), against JAX's unsharded ``make_unclip_train_step`` with
  ``optax.adamw`` from the same parameters with JAX's t and noise: the
  loss within 1e-5, the parameters and EMA within 2e-5
  (``tests/test_fsdp_accum.py``'s tolerance), each rank holding 1/N of the
  largest leaves;
* ``train_unclip(fsdp=2)``'s checkpoints: the unsharded format, a bitwise
  resume under ``fsdp=2`` and a resume unsharded within 1e-6.

Adam's first update is the sign of each gradient, which rounding decides
wherever a gradient is at rounding level, so the steps run ``optax.adamw``
with ``eps`` 1e-3: the update is then a smooth function of the gradient and
the comparison holds the step, not the rounding of near-zero gradients.
"""

import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_sharding_audit as jaudit_trees
import torch_fsdp_ranks as ranks
from kandinsky2_tpu.configs import CONFIG_2_1, create_model as jcreate_model
from kandinsky2_tpu.configs import deep_copy_config
from kandinsky2_tpu.parallel import make_mesh as jax_make_mesh
from kandinsky2_tpu.parallel import mesh as jmesh
from kandinsky2_tpu.train import resample as jres
from kandinsky2_tpu.train.train_unclip import decoder_freeze_mask as jax_freeze_mask
from kandinsky2_tpu.train.train_unclip import make_unclip_train_step as jax_train_step
from kandinsky2_tpu.train.train_unclip import masked_optimizer
from kandinsky2_tpu_torch.parallel.launch import RankPool
from kandinsky2_tpu_torch.parallel.mesh import P, _fsdp_augment, fsdp_state_shardings
from kandinsky2_tpu_torch.weights.from_jax import jax_to_state_dict, plan
from test_torch_common import assert_close, numpy_params

N = 4
B, HL = 8, 16
ADAMW = {"name": "optax.adamw", "params": {"learning_rate": 1e-3, "eps": 1e-3}}
STEP_TOL, PARAM_TOL = 1e-5, 2e-5


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N, device="cpu")
    p.start()  # the ranks join while the JAX side compiles
    yield p
    p.close()


@pytest.fixture(scope="module", autouse=True)
def jax_steps_started():
    """JAX's unsharded steps (``_jax_steps``) on a thread of their own from
    the module's start."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_jax_steps)


# --- the placement ---------------------------------------------------------------------


@pytest.mark.parametrize("spec,shape,size,min_elems", [
    (P(), (3, 3, 1536, 1536), 4, 1 << 16),
    (P(), (384, 1536), 8, 1 << 16),
    (P(None, "model"), (1536, 4608), 4, 1 << 16),
    (P(None, None, None, "model"), (3, 3, 768, 768), 2, 1 << 16),
    (P(), (1536,), 4, 1 << 16),
    (P(), (7, 5, 9), 4, 1),
    (P(), (64, 64), 1, 1),
])
def test_fsdp_augment_matches_jax(spec, shape, size, min_elems):
    want = jmesh._fsdp_augment(jax.sharding.PartitionSpec(*spec), shape, "data", size,
                               min_elems)
    assert tuple(_fsdp_augment(spec, shape, "data", size, min_elems)) == tuple(want)


@pytest.fixture(scope="module")
def fullsize():
    """The full-size CONFIG_2_1 UNet on the meta device with an EMA of meta
    tensors, and JAX's ``eval_shape`` tree of it."""
    from kandinsky2_tpu_torch.configs import create_model
    from kandinsky2_tpu_torch.train.train_unclip import TrainState

    unet = create_model(**dict(CONFIG_2_1["model_config"], inpainting=False),
                        device="meta")
    ema = {n: torch.empty_like(p) for n, p in unet.named_parameters()}
    shapes = jaudit_trees.TREES["unet21"][0]()
    bridge = plan(shapes, {k: tuple(v.shape) for k, v in unet.state_dict().items()})
    return TrainState(unet, None, ema, None), shapes, bridge


# a JAX leaf's dim -> the port's dim, by the bridge's transform
_TO_TORCH = {"hwio": (2, 3, 1, 0), "io": (1, 0), "io1": (1, 0), "io11": (1, 0)}


@pytest.mark.parametrize("data,model,tp", [(4, 1, False), (8, 1, False), (2, 4, True),
                                           (4, 2, True)],
                         ids=["data 4", "data 8", "tp data 2 model 4", "tp data 4 model 2"])
def test_placement_matches_jax(fullsize, data, model, tp):
    """Every parameter's and EMA leaf's spec, moved to the torch dims, is
    JAX's; the largest leaves are cut."""
    state, shapes, bridge = fullsize
    jmesh_ = jax_make_mesh(data * model, model_parallel=model)
    jspecs = jmesh.fsdp_state_shardings({"params": shapes, "ema_params": shapes}, jmesh_,
                                        tp=tp)
    flat = {"params": _flat_specs(jspecs["params"]), "ema": _flat_specs(jspecs["ema_params"])}
    got = fsdp_state_shardings(state, {"data": data, "model": model}, tp=tp)
    assert set(got["params"]) == set(bridge) and set(got["ema"]) == set(bridge)
    n_cut = n_both = 0
    for key, (path, op) in bridge.items():
        ndim = len(shapes_leaf(shapes, path).shape)
        torch_ndim = len(state.model.get_parameter(key).shape)
        for tree in ("params", "ema"):
            spec = list(flat[tree][path]) + [None] * (ndim - len(flat[tree][path]))
            want = [None] * torch_ndim
            for i, ax in enumerate(spec):
                if ax is not None:
                    want[_TO_TORCH.get(op, range(8))[i]] = ax
            assert list(got[tree][key]) == want, (key, tree, got[tree][key], spec)
        n_cut += "data" in got["params"][key]
        n_both += "data" in got["params"][key] and "model" in got["params"][key]
    assert n_cut > 100 and (n_both > 50 if tp else n_both == 0), (n_cut, n_both)


def _flat_specs(tree) -> dict:
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(p.key for p in path)] = tuple(s.spec)
    return out


def shapes_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --- Adafactor on slices -------------------------------------------------------------


ADAFACTOR_KW = dict(learning_rate=1e-2, min_dim_size_to_factor=8, momentum=0.9,
                    clipping_threshold=1.0, multiply_by_parameter_scale=True,
                    weight_decay_rate=1e-3)


def test_adafactor_on_slices_matches_optax(pool):
    """Three steps of the port's Adafactor on four ranks, each holding a
    quarter of: a factored [24, 16] cut on its d0 (dim 0, the largest), the
    same shape cut on its d1 (dim 1), a factored conv [20, 16, 3, 3] cut on
    its d1 and a vector [32] (not factored), beside a whole [8, 12];
    against ``optax.adafactor`` on the whole tensors within 1e-5."""
    rng = np.random.RandomState(70)
    cases = {"d0 cut": ((24, 16), 0), "d1 cut": ((24, 16), 1),
             "conv d1 cut": ((20, 16, 3, 3), 1), "vector": ((32,), 0), "whole": ((8, 12), None)}
    p0 = {k: rng.randn(*shape).astype(np.float32) for k, (shape, _) in cases.items()}
    grads = [{k: (rng.randn(*shape) * scale).astype(np.float32)
              for k, (shape, _) in cases.items()} for scale in (1.0, 30.0, 1e-2)]
    got = pool.run(ranks.adafactor_shards, {k: (p0[k], d) for k, (_, d) in cases.items()},
                   grads, ADAFACTOR_KW)[0]
    tx = optax.adafactor(**ADAFACTOR_KW)
    p = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(p)
    for g in grads:
        u, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, p)
        p = optax.apply_updates(p, u)
    for k in cases:
        assert_close(got[k]["param"], np.asarray(p[k]), STEP_TOL, k)
        assert got[k]["param"].shape == p0[k].shape
    assert set(got["d0 cut"]) == {"param", "v_row", "v_col", "ema"}
    assert set(got["vector"]) == {"param", "v", "ema"}


# --- the step --------------------------------------------------------------------------


def tiny_config():
    """tests/test_fsdp_accum.py's tiny 2.1 UNet."""
    cfg = deep_copy_config(CONFIG_2_1)
    cfg["model_config"].update(
        num_channels=32, num_res_blocks=1, channel_mult="1,2",
        attention_resolutions="32", num_head_channels=16, model_dim=32,
        text_encoder_in_dim1=16, text_encoder_in_dim2=32,
        image_encoder_in_dim=32, num_image_embs=2, inpainting=False)
    return cfg


def make_batch(seed):
    rng = np.random.RandomState(seed)
    return {"image_latents": rng.randn(B, HL, HL, 4).astype(np.float32),
            "full_emb": rng.randn(B, 7, 16).astype(np.float32),
            "pooled_emb": rng.randn(B, 32).astype(np.float32),
            "image_emb": rng.randn(B, 32).astype(np.float32)}


def _jax_params(cfg, batch, seed):
    jm = jcreate_model(**cfg["model_config"], dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch["image_latents"],
                            jnp.zeros((B,)), full_emb=batch["full_emb"],
                            pooled_emb=batch["pooled_emb"], image_emb=batch["image_emb"])
    return jm, numpy_params(shapes["params"], seed)


def _jax_steps():
    """Two steps of JAX's unsharded step (masked ``optax.adamw``, EMA 0.999,
    the loss-aware sampler), compiled once, and each step's t and noise."""
    cfg = tiny_config()
    batch = make_batch(80)
    jm, params = _jax_params(cfg, batch, 81)
    mask = jax_freeze_mask(params, freeze_resblocks=True)
    tx = masked_optimizer(optax.adamw(**ADAMW["params"]), mask)
    init_state, step = jax_train_step(jm, cfg["diffusion_config"], tx, ema_decay=0.999,
                                      schedule_sampler="loss-second-moment")
    step = jax.jit(step)
    key = jax.random.PRNGKey(7)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    state, draws, metrics = init_state(params), [], []
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        rng_t, rng_n = jax.random.split(jax.random.fold_in(key, int(state.step)))
        t, _ = jres.loss_aware_sample(rng_t, state.sampler_state, B)
        draws.append((np.asarray(t), np.asarray(jax.random.normal(
            rng_n, batch["image_latents"].shape, jnp.float32))))
        state, m = step(state, jb, key)
        metrics.append(host(m))
    return dict(cfg=cfg, params=params, batch=batch, draws=draws, state=host(state),
                metrics=metrics)


@pytest.fixture(scope="module")
def jax_steps(jax_steps_started):
    return jax_steps_started.result()


@pytest.mark.parametrize("shape,kw", [
    ((N, 1), {}),
    ((2, 2), {"tp": True, "tp_min_size": 64}),
    ((2, 1), {"accum_steps": 2}),
], ids=["data 4", "tp data 2 model 2", "accum 2 data 2"])
def test_fsdp_steps_match_jax(pool, jax_steps, shape, kw):
    from kandinsky2_tpu_torch.configs import create_model

    j = jax_steps
    ts, noises = zip(*j["draws"])
    res = pool.run(ranks.fsdp_steps, shape, j["cfg"]["model_config"],
                   j["cfg"]["diffusion_config"], j["params"], j["batch"], ts, noises,
                   ADAMW, **kw)
    n = shape[0] * shape[1]
    assert all(r is None for r in res[n:])
    res = res[:n]
    r = res[0]
    assert r["step"] == 2
    for i, (m, jm) in enumerate(zip(r["metrics"], j["metrics"])):
        for key in ("loss", "mse", "vb"):
            assert_close(m[key], jm[key], STEP_TOL, f"step {i + 1} {key}")
    np.testing.assert_array_equal(r["counts"], np.asarray(j["state"].sampler_state.counts))
    assert_close(r["history"], j["state"].sampler_state.history, STEP_TOL, "sampler history")
    unet = create_model(**j["cfg"]["model_config"], dtype=torch.float32)
    for key, tree in (("params", j["state"].params), ("ema", j["state"].ema_params)):
        for name, w in jax_to_state_dict(tree, unet).items():
            err = float(np.abs(r[key][name] - w.numpy()).max())
            assert err <= PARAM_TOL, f"{key} {name}: max abs diff {err:.3e} > {PARAM_TOL}"
    for other in res[1:]:
        for name, a in r["params"].items():
            np.testing.assert_array_equal(other["params"][name], a, err_msg=name)
    # each rank holds its slice: the largest parameter and its EMA, the
    # largest trainable one and its moments
    big = max(r["held"], key=lambda k: r["held"][k][1])
    big_t = max(r["opt_held"], key=lambda k: r["held"][k][1])
    for q in res:
        for name in (big, big_t):
            local, whole = q["held"][name]
            assert local * n == whole, (name, local, whole)
            assert q["ema_held"][name] == local
        assert q["opt_held"][big_t] == {"mu": q["held"][big_t][0], "nu": q["held"][big_t][0]}
        assert q["placed"] and set(q["moments"]) == set(q["opt_held"])
        assert all(q["moments"].values())
    assert r["collectives"]["all_gather"] > 0 and r["collectives"]["reduce_scatter"] > 0


# --- checkpoints ---------------------------------------------------------------------


def test_fsdp_checkpoints_resume_bitwise_and_unsharded(pool, jax_steps, tmp_path):
    """``train_unclip(fsdp=2)`` saving every step: three steps straight;
    two, then a resume for the third, bitwise equal to them; and the same
    saved state resumed unsharded, within 1e-6.  The file has the
    unsharded format: the unsharded resume's own save has the same keys,
    shapes and dtypes."""
    j = jax_steps
    batches = [make_batch(90 + i) for i in range(3)]
    args = (j["cfg"]["model_config"], j["cfg"]["diffusion_config"], j["params"])
    straight = pool.run(ranks.train_loop, *args, batches, str(tmp_path / "a"), ADAMW, 2)[0]
    first = pool.run(ranks.train_loop, *args, batches[:2], str(tmp_path / "b"), ADAMW, 2)[0]
    assert first["step"] == 2 and "state_00000002.pt" in first["files"]
    shutil.copytree(tmp_path / "b", tmp_path / "c")
    resumed = pool.run(ranks.train_loop, *args, batches[2:], str(tmp_path / "b"), ADAMW, 2)[0]
    unsharded = pool.run(ranks.train_loop, *args, batches[2:], str(tmp_path / "c"), ADAMW,
                         None)[0]
    assert straight["step"] == resumed["step"] == unsharded["step"] == 3
    for key in ("params", "ema"):
        for name, a in straight[key].items():
            np.testing.assert_array_equal(resumed[key][name], a, err_msg=f"{key} {name}")
            assert_close(unsharded[key][name], a, 1e-6, f"unsharded {key} {name}")
    for i, st in straight["opt"].items():
        for k, a in st.items():
            np.testing.assert_array_equal(resumed["opt"][i][k], a, err_msg=f"{i} {k}")
    load = lambda d, s: torch.load(os.path.join(tmp_path, d, f"state_{s:08d}.pt"),
                                   weights_only=True)
    sharded_file, own_file = load("b", 2), load("c", 3)
    for key in ("params", "ema"):
        assert {k: (tuple(v.shape), v.dtype) for k, v in sharded_file[key].items()} == {
            k: (tuple(v.shape), v.dtype) for k, v in own_file[key].items()}
    assert {i: {k: tuple(v.shape) for k, v in st.items() if torch.is_tensor(v)}
            for i, st in sharded_file["optimizer"]["state"].items()} == {
        i: {k: tuple(v.shape) for k, v in st.items() if torch.is_tensor(v)}
        for i, st in own_file["optimizer"]["state"].items()}
