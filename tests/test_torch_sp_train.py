"""Row-sharded (sp × data) training of the 2.1 decoder in the port against
the JAX package, on the CPU in fp32.

The port runs one process per shard: one pool of four gloo ranks on
loopback (``torch_sp_train_ranks``, the rank side) serves every case.  The
JAX side runs in this process on the virtual devices of
``tests/conftest.py``.  Held here:

* each collective's backward against its transpose written out in numpy;
* the sharded GroupNorm's gradient (x, scale, bias, FiLM) against the
  unsharded ``GroupNorm32``'s, and at mean/std 1000 against fp64;
* the gathered attention's, the ring fold's and ``RingFlashFunction``'s
  (the flash kernels' plain versions) gradients, with a text prefix and
  query chunking, against the unsharded attention's;
* the row-sharded UNet's gradients in the setup of JAX's
  ``test_spatial_unet_gradients_match_single_device`` against JAX's
  gradient (1e-4 relative L2 a tensor) and the port's unsharded one
  (1e-5), in both ``resblock_updown`` layouts and with the ring forced;
* two steps of ``make_spdp_train_fn`` on a (data 2, sp 2) mesh against
  JAX's ``make_spdp_train_fn`` on 4 virtual devices (compiled once), with
  JAX's t and noise draws handed to the ranks: loss, sampler history,
  parameters and EMA within 1e-5, the parameters bitwise equal across
  ranks; with ``accum_steps=2`` too, and the inpainting UNet against the
  unsharded step;
* ``make_prior_train_step(data_axis=)`` against JAX's under ``shard_map``;
* ``train_unclip(mesh_shape=)``'s save on rank 0 and resume on every rank,
  and the CLI's ``parallel`` key on the four ranks, ``fsdp`` refused.

Optimizer: ``optax.sgd``.  Adam's first update is the sign of each
gradient, which rounding decides for the conv biases whose gradient is
zero in exact arithmetic (a bias before a GroupNorm of one channel a
group), so it would compare rounding, not the step.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from jax.sharding import Mesh, PartitionSpec as P

import torch_sp_train_ranks as ranks
from kandinsky2_tpu.configs import CONFIG_2_1, create_model as jcreate_model
from kandinsky2_tpu.configs import deep_copy_config
from kandinsky2_tpu.models.prior import PriorTransformer as JPrior
from kandinsky2_tpu.models.unet import UNetModel as JaxUNet
from kandinsky2_tpu.train import resample as jres
from kandinsky2_tpu.train.train_prior import make_prior_train_step as jprior_step
from kandinsky2_tpu.train.train_unclip import make_spdp_train_fn as jspdp
from kandinsky2_tpu_torch.parallel.launch import RankPool
from kandinsky2_tpu_torch.train import train_2_1_unclip as tcli
from kandinsky2_tpu_torch.train import train_unclip as tunclip
from test_torch_common import assert_close, numpy_params

N = 4
LR = 0.05


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N, device="cpu")
    p.start()  # the ranks join while the JAX side compiles
    yield p
    p.close()


@pytest.fixture(scope="module", autouse=True)
def jax_spdp_started():
    """JAX's spdp steps (``_jax_spdp``), traced and compiled on a thread of
    their own from the module's start, while the ranks run the cases
    before them."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_jax_spdp)


def rand(seed, *shape, scale=1.0, loc=0.0):
    return (loc + scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def rel_l2(got, want, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), floor, 1e-30))


# --- the collectives -----------------------------------------------------------


def _transpose(kind, gs, rows):
    """Each rank's gradient of sum(collective(x_r) · g_r), in numpy."""
    n = len(gs)
    if kind == "ppermute":  # x_i lands on rank i + 1
        return np.stack([gs[(i + 1) % n] for i in range(n)])
    if kind in ("psum", "pmean"):
        total = gs.sum(0) / (n if kind == "pmean" else 1)
        return np.stack([total] * n)
    if kind == "all_gather":
        return np.stack([gs.sum(0)[:, i * rows:(i + 1) * rows] for i in range(n)])
    out = []
    for i in range(n):
        if kind == "halo_exchange_rows":  # [top; x; bottom]
            dx = gs[i][:, 1:-1].copy()
            if i + 1 < n:
                dx[:, -1] += gs[i + 1][:, 0]
            if i > 0:
                dx[:, 0] += gs[i - 1][:, -1]
        else:  # halo_below_rows: [x; the next rank's first row]
            dx = gs[i][:, :-1].copy()
            if i > 0:
                dx[:, 0] += gs[i - 1][:, -1]
        out.append(dx)
    return np.stack(out)


@pytest.mark.parametrize("kind", ["ppermute", "psum", "pmean", "all_gather",
                                  "halo_exchange_rows", "halo_below_rows"])
def test_collective_backward_is_its_transpose(pool, kind):
    B, rows, W, C = 2, 3, 4, 5
    xs = rand(1, N, B, rows, W, C)
    out_rows = {"all_gather": rows * N, "halo_exchange_rows": rows + 2,
                "halo_below_rows": rows + 1}.get(kind, rows)
    gs = rand(2, N, B, out_rows, W, C)
    got = pool.run(ranks.collective_grads, kind, xs, gs)[0]
    np.testing.assert_allclose(got, _transpose(kind, gs, rows), rtol=1e-6, atol=1e-6)


# --- the sharded GroupNorm -----------------------------------------------------

GN_CASES = {
    "silu film": dict(C=64, groups=32, swish=1.0, film=True, loc=0.5, scale=2.0),
    "groups 8": dict(C=32, groups=8, swish=0.0, film=False, loc=-3.0, scale=0.5),
}
GN_GRADS = ("x", "scale", "bias", "film scale", "film shift")


def _gn_inputs(c, loc=None, scale=None):
    B, C = 2, c["C"]
    x = rand(2, B, 16, 8, C, scale=c["scale"] if scale is None else scale,
             loc=c["loc"] if loc is None else loc)
    gy = rand(7, B, 16, 8, C)
    w, b = 1 + rand(3, C, scale=0.1), rand(4, C, scale=0.1)
    film = (rand(5, B, 1, 1, C, scale=0.1), rand(6, B, 1, 1, C, scale=0.1)) \
        if c["film"] else None
    return x, gy, w, b, film


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(GN_CASES))
def test_sharded_group_norm_gradient_matches_unsharded(pool, n, case):
    c = GN_CASES[case]
    x, gy, w, b, film = _gn_inputs(c)
    got, whole = pool.run(ranks.group_norm_grads, n, x, gy, w, b, c["groups"],
                          c["swish"], film)[0]
    assert len(got) == (5 if film else 3)
    for name, g, want in zip(GN_GRADS, got, whole):
        assert rel_l2(g, want) <= 1e-5, f"{case} sp{n}: d {name} {rel_l2(g, want):.3e}"


def _group_norm_fp64(x, w, b, film, groups, swish):
    B, C = x.shape[0], x.shape[-1]
    xg = x.reshape(B, -1, groups, C // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + 1e-5)).reshape(x.shape) * w + b
    if film is not None:
        y = y * (1 + film[0]) + film[1]
    return y * torch.sigmoid(swish * y) if swish else y


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_group_norm_gradient_far_mean_matches_fp64(pool, n):
    """Each group's mean 1000 standard deviations from zero, with FiLM and
    SiLU: every gradient within 1e-4 relative L2 of the fp64 gradient."""
    c = GN_CASES["silu film"]
    x, gy, w, b, film = _gn_inputs(c, loc=1000.0, scale=1.0)
    got, _ = pool.run(ranks.group_norm_grads, n, x, gy, w, b, c["groups"], 1.0,
                      film)[0]
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in (x, w, b, *film)]
    y = _group_norm_fp64(leaves[0], leaves[1], leaves[2], leaves[3:], c["groups"], 1.0)
    y.backward(torch.tensor(gy, dtype=torch.float64))
    for name, g, t in zip(GN_GRADS, got, leaves):
        err = rel_l2(g, t.grad.numpy())
        assert err <= 1e-4, f"sp{n} mean/std 1000: d {name} {err:.3e} from fp64"


# --- sharded attention ---------------------------------------------------------


@pytest.mark.parametrize("impl", ["gathered", "ring", "ring flash"])
def test_sharded_attention_gradients_match_unsharded(pool, impl):
    """The UNet's attention with a 5-token text prefix over 24 spatial
    tokens, 6 a rank (the ring's queries in chunks of 4): the gradients of
    q, k, v and the prefix within 1e-5 of the unsharded attention's."""
    B, T, H, c, E = 2, 24, 3, 8, 5
    q, k, v, go = (rand(80 + i, B, T, H, c) for i in range(4))
    ek, ev = (rand(85 + i, B, E, H, c) for i in range(2))
    got, whole = pool.run(ranks.attention_grads, impl, q, k, v, ek, ev, go)[0]
    for name, g, want in zip(("q", "k", "v", "prefix k", "prefix v"), got, whole):
        assert rel_l2(g, want) <= 1e-5, f"{impl}: d {name} {rel_l2(g, want):.3e}"


# --- the row-sharded UNet ------------------------------------------------------

UNET_KW = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
               attention_resolutions=(2,), channel_mult=(1, 2), num_heads=1,
               num_head_channels=16)


@pytest.fixture(scope="module")
def jax_unet_grads():
    """JAX's loss and gradient of the unsharded UNet, by layout (the setup
    of tests/test_spatial_parallel.py's gradient test, numpy-seeded)."""
    cache = {}

    def get(updown):
        if updown not in cache:
            jm = JaxUNet(**UNET_KW, resblock_updown=updown, use_encoder_kv=True)
            x, tgt = rand(16, 2, 16, 16, 4), rand(18, 2, 16, 16, 4)
            t, enc = np.asarray([3.0, 7.0], np.float32), rand(17, 2, 5, 32)
            params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x,
                                                 t, enc)["params"], 19)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jnp.mean((jm.apply({"params": p}, x, t, enc) - tgt) ** 2)))(
                params)
            cache[updown] = dict(params=params, x=x, t=t, enc=enc, tgt=tgt,
                                 loss=float(loss), grads=grads)
        return cache[updown]

    return get


@pytest.mark.parametrize("updown,ring", [(True, False), (False, False), (True, True)],
                         ids=["resblock_updown", "conv_updown", "ring attention"])
def test_sharded_unet_gradients_match_jax(pool, jax_unet_grads, updown, ring):
    """Every parameter's gradient within 1e-4 relative L2 of JAX's and 1e-5
    of the port's unsharded one.  Where JAX's gradient is numerically zero
    (its norm under 1e-5 of the median tensor's: the conv biases before a
    GroupNorm of one channel a group, whose gradient is zero in exact
    arithmetic, rounding noise of 1e-8 on both sides) the port's must be
    too."""
    from kandinsky2_tpu_torch.models.unet import UNetModel
    from kandinsky2_tpu_torch.weights.from_jax import jax_to_state_dict

    j = jax_unet_grads(updown)
    kw = dict(UNET_KW, resblock_updown=updown, encoder_channels=32)
    r = pool.run(ranks.unet_grads, kw, j["params"], j["x"], j["t"], j["enc"], j["tgt"],
                 ring)[0]
    want = {n: w.numpy() for n, w in
            jax_to_state_dict(j["grads"], UNetModel(**kw)).items()}
    assert set(want) == set(r["grads"])
    zero = 1e-5 * float(np.median([np.linalg.norm(w) for w in want.values()]))
    assert abs(r["loss"] - j["loss"]) <= 1e-5 * j["loss"]
    n_zero = 0
    for name in r["names"]:
        got = r["grads"][name]
        if np.linalg.norm(want[name]) <= zero:
            n_zero += 1
            assert np.linalg.norm(got) <= zero, f"{name}: zero in JAX, not here"
            continue
        err_jax, err_own = rel_l2(got, want[name]), rel_l2(got, r["ref"][name])
        assert err_jax <= 1e-4, f"{name}: {err_jax:.3e} from JAX"
        assert err_own <= 1e-5, f"{name}: {err_own:.3e} from unsharded"
    assert n_zero <= 8, n_zero


# --- make_spdp_train_fn --------------------------------------------------------

B, HL = 4, 16
SHAPE = (2, 2)


def tiny_config(inpainting=False):
    """tests/test_sp_train.py's tiny 2.1 UNet."""
    cfg = deep_copy_config(CONFIG_2_1)
    mc = cfg["model_config"]
    mc.update(num_channels=32, num_res_blocks=1, channel_mult="1,2",
              attention_resolutions="32", num_head_channels=16, model_dim=32,
              text_encoder_in_dim1=16, text_encoder_in_dim2=32,
              image_encoder_in_dim=32, num_image_embs=2, inpainting=inpainting)
    return cfg


def spdp_batch(seed, inpainting=False):
    batch = {"image_latents": rand(seed, B, HL, HL, 4),
             "full_emb": rand(seed + 1, B, 7, 16),
             "pooled_emb": rand(seed + 2, B, 32),
             "image_emb": rand(seed + 3, B, 32)}
    if inpainting:
        mask = (np.random.RandomState(seed + 4).rand(B, HL, HL, 1) > 0.5).astype(np.float32)
        batch["inpaint_mask"] = mask
        batch["inpaint_image"] = batch["image_latents"] * mask
    return batch


def jax_draws(state, key, b_local):
    """The t [B] and noise of a JAX spdp step over the whole batch: JAX's
    key folds (step, data index) for t, and the sp index too for each
    shard's noise rows (``train_unclip.py:139-154``)."""
    d, s = SHAPE
    ts, noise = [], np.zeros((B, HL, HL, 4), np.float32)
    hl = HL // s
    for di in range(d):
        rng = jax.random.fold_in(jax.random.fold_in(key, int(state.step)), di)
        rng_t, rng_n = jax.random.split(rng)
        t, _ = jres.loss_aware_sample(rng_t, state.sampler_state, b_local)
        ts.append(np.asarray(t))
        for si in range(s):
            nz = jax.random.normal(jax.random.fold_in(rng_n, si), (b_local, hl, HL, 4))
            noise[di * b_local:(di + 1) * b_local, si * hl:(si + 1) * hl] = np.asarray(nz)
    return np.concatenate(ts), noise


def _jax_spdp():
    """Two steps of JAX's make_spdp_train_fn on a (data 2, sp 2) mesh of 4
    virtual devices (loss-second-moment sampler, EMA 0.999, optax.sgd),
    compiled once, and each step's draws."""
    cfg = tiny_config()
    jm = jcreate_model(**cfg["model_config"], dtype=jnp.float32)
    batch = spdp_batch(30)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb["image_latents"],
                            jnp.zeros((B,)), full_emb=jb["full_emb"],
                            pooled_emb=jb["pooled_emb"], image_emb=jb["image_emb"])
    params = numpy_params(shapes["params"], 31)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(SHAPE), ("data", "sp"))
    init_state, train_fn = jspdp(jm, cfg["diffusion_config"], optax.sgd(LR), mesh,
                                 schedule_sampler="loss-second-moment", ema_decay=0.999)
    key = jax.random.PRNGKey(7)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # one compile
    state, draws, metrics = host(init_state(params)), [], []
    for _ in range(2):
        draws.append(jax_draws(state, key, B // SHAPE[0]))
        state, m = train_fn(state, jb, key)
        state, m = host(state), host(m)
        metrics.append(m)
    return dict(cfg=cfg, params=params, batch=batch, draws=draws, state=state,
                metrics=metrics)


@pytest.fixture(scope="module")
def jax_spdp(jax_spdp_started):
    return jax_spdp_started.result()


def _check_replicated(results, keys=("params", "ema")):
    for r in results[1:]:
        for key in keys:
            if results[0][key] is None:
                continue
            for name, a in results[0][key].items():
                np.testing.assert_array_equal(r[key][name], a, err_msg=f"{key} {name}")


@pytest.mark.parametrize("accum_steps,sharded", [(1, False), (2, True)],
                         ids=["whole batch", "accum 2, each rank's shard"])
def test_spdp_two_steps_match_jax(pool, jax_spdp, accum_steps, sharded):
    """The whole batch on every rank, and with ``accum_steps=2`` each
    rank's own shard of it (``sharded=True``)."""
    from kandinsky2_tpu_torch.configs import create_model
    from kandinsky2_tpu_torch.weights.from_jax import jax_to_state_dict

    j = jax_spdp
    ts, noises = zip(*j["draws"])
    res = pool.run(ranks.spdp_steps, SHAPE, j["cfg"]["model_config"],
                   j["cfg"]["diffusion_config"], j["params"], j["batch"], ts, noises,
                   LR, accum_steps, sharded=sharded)
    _check_replicated(res)
    r = res[0]
    assert r["step"] == 2
    for i, (m, jm) in enumerate(zip(r["metrics"], j["metrics"])):
        for key in ("loss", "mse", "vb"):
            assert_close(m[key], jm[key], 1e-5, f"step {i + 1} {key}")
    np.testing.assert_array_equal(r["counts"], np.asarray(j["state"].sampler_state.counts))
    assert_close(r["history"], j["state"].sampler_state.history, 1e-5, "sampler history")
    unet = create_model(**j["cfg"]["model_config"], dtype=torch.float32)
    for key, tree in (("params", j["state"].params), ("ema", j["state"].ema_params)):
        want = jax_to_state_dict(tree, unet)
        for name, w in want.items():
            assert_close(r[key][name], w, 1e-5, f"{key} {name} (accum {accum_steps})")


def test_spdp_inpainting_matches_the_unsharded_step(pool):
    """The inpainting UNet's inpaint_image and inpaint_mask are sharded over
    (data, sp) like the latents: two steps within 1e-5 of the unsharded
    step on the whole batch (held against JAX's in test_torch_train.py)."""
    cfg = tiny_config(inpainting=True)
    jm = jcreate_model(**cfg["model_config"], dtype=jnp.float32)
    batch = spdp_batch(40, inpainting=True)
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), batch["image_latents"], jnp.zeros((B,)),
        full_emb=batch["full_emb"], pooled_emb=batch["pooled_emb"],
        image_emb=batch["image_emb"], inpaint_image=batch["inpaint_image"],
        inpaint_mask=batch["inpaint_mask"])
    params = numpy_params(shapes["params"], 41)
    rng = np.random.RandomState(42)
    ts = [rng.randint(0, 1000, B) for _ in range(2)]
    noises = [rng.randn(B, HL, HL, 4).astype(np.float32) for _ in range(2)]
    args = (cfg["model_config"], cfg["diffusion_config"], params, batch, ts, noises, LR)
    res = pool.run(ranks.spdp_steps, SHAPE, *args, sampler="uniform", ema_decay=None)
    whole = pool.run(ranks.single_steps, *args)[0]
    _check_replicated(res)
    for m, w in zip(res[0]["metrics"], whole["metrics"]):
        assert_close(m["loss"], w["loss"], 1e-5, "inpainting loss")
    for name, w in whole["params"].items():
        assert_close(res[0]["params"][name], w, 1e-5, f"inpainting {name}")


# --- the prior's data axis -----------------------------------------------------

PRIOR_HP = dict(text_ctx=8, xf_width=32, xf_layers=2, xf_heads=2, xf_final_ln=True,
                clip_dim=16, clip_xf_width=24)
with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "train_configs", "config_prior.yaml")) as _f:
    PRIOR_DCFG = yaml.safe_load(_f)["model_config"]["diffusion"]


def test_prior_data_axis_matches_jax(pool):
    """make_prior_train_step(data_axis=) on 2 ranks against JAX's
    make_prior_train_step(data_axis="data") under shard_map on 2 devices,
    one step with JAX's draws (each shard draws from the same key)."""
    from kandinsky2_tpu_torch.models.prior import PriorTransformer
    from kandinsky2_tpu_torch.weights.from_jax import jax_to_state_dict

    jp = JPrior(**PRIOR_HP, dtype=jnp.float32)
    rng = np.random.RandomState(50)
    b = 4
    batch = {"image_emb": rng.randn(b, 16).astype(np.float32),
             "txt_feat": rng.randn(b, 16).astype(np.float32),
             "txt_feat_seq": rng.randn(b, 8, 24).astype(np.float32),
             "mask": np.ones((b, 8), bool)}
    batch["mask"][1, 5:] = False
    shapes = jax.eval_shape(jp.init, jax.random.PRNGKey(0), batch["image_emb"],
                            jnp.zeros((b,)), batch["txt_feat"], batch["txt_feat_seq"],
                            batch["mask"])
    params = numpy_params(shapes["params"], 51)
    init_state, step = jprior_step(jp, PRIOR_DCFG, optax.sgd(LR), ema_decay=0.9999,
                                   data_axis="data")
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    f = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P(), P("data"), P()),
                              out_specs=(P(), P()), check_vma=False))
    key = jax.random.PRNGKey(3)
    state, metrics = f(init_state(params), batch, key)
    rng_t, rng_n = jax.random.split(jax.random.fold_in(key, 0))
    t, _ = jres.uniform_sample(rng_t, 1000, b // 2)
    noise = np.asarray(jax.random.normal(rng_n, (b // 2, 16), jnp.float32))
    t_all, noise_all = np.tile(np.asarray(t), 2), np.concatenate([noise, noise])
    res = pool.run(ranks.prior_steps, 2, PRIOR_HP, PRIOR_DCFG, params, batch,
                   [t_all], [noise_all], LR)
    assert_close(res[0]["losses"][0], float(metrics["loss"]), 1e-5, "prior loss")
    _check_replicated(res[:2], keys=("params",))
    want = jax_to_state_dict(state.params, PriorTransformer(**PRIOR_HP))
    for name, w in want.items():
        assert_close(res[0]["params"][name], w, 1e-5, f"prior {name}")


# --- the loop and the CLI ------------------------------------------------------


def test_train_unclip_mesh_saves_on_rank_0_and_resumes_every_rank(pool, tmp_path):
    """``train_unclip(mesh_shape=(2, 2))``: rank 0 writes the whole state
    each step; a second run resumes on every rank from it (the same step,
    parameters and generator on each, so the ranks stay bitwise equal and
    train on from step 2)."""
    cfg = tiny_config()
    jm = jcreate_model(**cfg["model_config"], dtype=jnp.float32)
    batches = [spdp_batch(60 + 10 * i) for i in range(3)]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batches[0]["image_latents"],
                            jnp.zeros((B,)), full_emb=batches[0]["full_emb"],
                            pooled_emb=batches[0]["pooled_emb"],
                            image_emb=batches[0]["image_emb"])
    params = numpy_params(shapes["params"], 61)
    args = (cfg["model_config"], cfg["diffusion_config"], params)
    path = str(tmp_path / "ckpt")
    first = pool.run(ranks.train_loop, *args, batches[:2], path, SHAPE, LR)
    assert [r["step"] for r in first] == [2] * N
    assert "state_00000002.pt" in first[0]["files"], first[0]["files"]
    _check_replicated(first, keys=("params",))
    second = pool.run(ranks.train_loop, *args, batches[2:], path, SHAPE, LR)
    assert [r["step"] for r in second] == [3] * N
    assert "state_00000003.pt" in second[0]["files"], second[0]["files"]
    _check_replicated(second, keys=("params",))
    assert any(not np.array_equal(second[0]["params"][n], a)
               for n, a in first[0]["params"].items())


def test_cli_parallel_key_trains_on_ranks_and_fsdp_raises(pool, tmp_path, monkeypatch):
    """``parallel: {data: 2, sp: 2}`` runs the spdp step on 4 CPU ranks (the
    tiny YAML of test_torch_train.py, two steps, checkpoints from rank 0;
    the CLI's rank pool is this module's, lent for the run); ``{fsdp: N}``
    and ``train_unclip(fsdp=)`` name what is missing."""
    from PIL import Image

    from kandinsky2_tpu_torch.parallel import launch
    from kandinsky2_tpu_torch.train import checkpoint as tckpt

    class Lent:
        def __init__(self, world, backend, device):
            assert (world, backend, device) == (N, "gloo", "cpu")

        def __enter__(self):
            return pool

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(launch, "RankPool", Lent)
    rng = np.random.RandomState(8)
    (tmp_path / "img").mkdir()
    rows = ["image_name,caption"]
    for i in range(4):
        Image.fromarray(rng.randint(0, 256, (64, 64, 3), np.uint8)).save(
            tmp_path / "img" / f"{i}.png")
        rows.append(f"{i}.png,a seeded picture {i}")
    (tmp_path / "data.csv").write_text("\n".join(rows) + "\n")
    cfg = tcli.small_train_config(str(tmp_path / "data.csv"), str(tmp_path / "img"),
                                  str(tmp_path / "ckpt"))
    cfg["parallel"] = {"data": 2, "sp": 2}
    out = tcli.run(cfg, device="cpu")
    assert out == {"step": 2, "world": N}
    assert tckpt.latest_train_state(str(tmp_path / "ckpt"))[1] == 2
    cfg["parallel"] = {"fsdp": 2}
    with pytest.raises(NotImplementedError, match="Queue 1 item 4, part 3"):
        tcli.run(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 4, part 3"):
        tunclip.train_unclip(unet=None, diffusion_config={}, loader=[],
                             prepare_batch=None, fsdp=2)
    with pytest.raises(ValueError, match="pick one"):
        tunclip.train_unclip(unet=None, diffusion_config={}, loader=[],
                             prepare_batch=None, fsdp=2, mesh_shape=(1, 2))
