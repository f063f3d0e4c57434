"""The port's 2.1 decoder fine-tuning (``kandinsky2_tpu_torch/train/`` and
the training terms of ``diffusion/gaussian.py``) against the JAX package's,
in fp32 on the CPU, with every input and parameter drawn from a numpy seed.

The UNet is the tiny one of ``tests/test_checkpoint_resume.py`` (32
channels, mult 1,2, 16-wide heads).  Its JAX loss, gradient and one train
step are computed once per module (``jax.jit``; op-by-op takes far longer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kandinsky2_tpu import configs as jcfg
from kandinsky2_tpu.diffusion import gaussian as jg
from kandinsky2_tpu.train import ema as jema
from kandinsky2_tpu.train import resample as jres
from kandinsky2_tpu.train.train_unclip import (
    decoder_freeze_mask as jax_freeze_mask,
    make_unclip_train_step as jax_make_step,
    masked_optimizer,
)
from kandinsky2_tpu_torch import configs as tcfg
from kandinsky2_tpu_torch.diffusion import gaussian as tg
from kandinsky2_tpu_torch.train import checkpoint as tckpt
from kandinsky2_tpu_torch.train import ema as tema
from kandinsky2_tpu_torch.train import optim as toptim
from kandinsky2_tpu_torch.train import resample as tres
from kandinsky2_tpu_torch.train import train_2_1_unclip as tcli
from kandinsky2_tpu_torch.train import train_unclip as ttrain
from kandinsky2_tpu_torch.utils import stub_tokenizers
from kandinsky2_tpu_torch.weights.from_jax import (
    flatten,
    jax_to_state_dict,
    load_jax_params,
    torch_key_for,
)
from test_torch_common import (
    MODULE_TOL,
    TINY_UNET,
    assert_close,
    numpy_params,
    profiled_spans,
)

T = torch.from_numpy
DCFG = jcfg.CONFIG_2_1["diffusion_config"]
SCHED_KW = dict(steps=1000, noise_schedule="linear", linear_start=0.00085,
                linear_end=0.012, rescale_timesteps=True)
B, LAT = 2, 16


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, over whole tensors."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_step_close(new, want_new, before, tol, what=""):
    """Parameters after an optimizer step: the port's update within ``tol``
    of the largest update, plus the rounding of p − u to fp32 (two ulps of
    the largest parameter), which both sides make."""
    new, want_new, before = (np.asarray(x, np.float32) for x in (new, want_new, before))
    bound = tol * np.abs(want_new - before).max() + 2 * np.spacing(np.abs(before).max())
    err = np.abs(new - want_new).max()
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


# --- diffusion training terms --------------------------------------------

def _toy_model(W):
    """A differentiable stand-in for the UNet, NHWC, 2C output channels."""
    def apply(x, lib):
        cat = lib.concatenate if lib is jnp else torch.cat
        tanh = lib.tanh
        kw = {"axis": -1} if lib is jnp else {"dim": -1}
        return W + cat([0.3 * x, 0.1 * tanh(x)], **kw)
    return apply


def test_training_losses_match_jax_at_t_including_0():
    """Hybrid MSE + frozen-mean VLB loss (loss, mse, vb) and its gradient in
    the toy model's parameter, NHWC (channel_axis=-1), at t = 0 (the
    decoder NLL), 1, 250 and 999."""
    rng = np.random.RandomState(0)
    x0 = np.tanh(rng.randn(4, 8, 8, 4)).astype(np.float32)
    noise = rng.randn(4, 8, 8, 4).astype(np.float32)
    t = np.array([0, 1, 250, 999])
    W = (0.1 * rng.randn(1, 1, 1, 8)).astype(np.float32)

    jsched = jg.make_schedule(**SCHED_KW)
    jkw = dict(mean_type=jg.MeanType.EPSILON, var_type=jg.VarType.LEARNED_RANGE,
               loss_type=jg.LossType.RESCALED_MSE, channel_axis=-1)

    def jloss(w):
        terms = jg.training_losses(jsched, lambda x, tt: _toy_model(w)(x, jnp),
                                   jnp.asarray(x0), jnp.asarray(t),
                                   jnp.asarray(noise), **jkw)
        return terms["loss"].sum(), terms

    (_, want), want_gw = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(W))

    tsched = tg.make_schedule(**SCHED_KW)
    w = T(W).requires_grad_()
    kw = dict(mean_type=tg.MeanType.EPSILON, var_type=tg.VarType.LEARNED_RANGE,
              loss_type=tg.LossType.RESCALED_MSE, channel_axis=-1)
    got = tg.training_losses(tsched, lambda x, tt: _toy_model(w)(x, torch),
                             T(x0), T(t), T(noise), **kw)
    got["loss"].sum().backward()
    for k in ("loss", "mse", "vb"):
        assert_close(got[k], want[k], MODULE_TOL, k)
    assert_close(w.grad, want_gw, MODULE_TOL, "d loss / d W")


@pytest.mark.parametrize("var", ["LEARNED", "LEARNED_RANGE", "FIXED_LARGE",
                                 "FIXED_SMALL"])
def test_p_mean_variance_var_types(var):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 6, 6, 4).astype(np.float32)
    C = 8 if var.startswith("LEARNED") else 4
    out = (0.5 * rng.randn(3, 6, 6, C)).astype(np.float32)
    t = np.array([0, 17, 900])
    want = jg.p_mean_variance(
        jg.make_schedule(**SCHED_KW), jnp.asarray(out), jnp.asarray(x),
        jnp.asarray(t), mean_type=jg.MeanType.EPSILON,
        var_type=jg.VarType[var], clip_denoised=False, channel_axis=-1)
    got = tg.p_mean_variance(
        tg.make_schedule(**SCHED_KW), T(out), T(x), T(t),
        mean_type=tg.MeanType.EPSILON, var_type=tg.VarType[var],
        clip_denoised=False, channel_axis=-1)
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        assert_close(np.broadcast_to(got[k].numpy(), x.shape),
                     np.broadcast_to(np.asarray(want[k]), x.shape), MODULE_TOL, k)


@pytest.mark.parametrize("dc", [
    dict(DCFG), dict(DCFG, use_kl=True), dict(DCFG, rescale_learned_sigmas=False),
    dict(DCFG, learn_sigma=False, predict_xstart=True, sigma_small=True),
])
def test_schedule_kwargs_loss_type(dc):
    want = jcfg.schedule_kwargs(dc, "")
    got = tcfg.schedule_kwargs(dc, "")
    for k in ("loss_type", "mean_type", "var_type"):
        assert got[k].value == want[k].value, k
    assert got["make_schedule"] == want["make_schedule"]


# --- EMA, sampler, freeze mask, Adafactor ---------------------------------

@pytest.mark.parametrize("n", [0, 1, 7, 100000, None])
def test_ema_warmup_matches_jax(n):
    rng = np.random.RandomState(2)
    ema = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    params = {k: rng.randn(*v.shape).astype(np.float32) for k, v in ema.items()}
    want = jema.ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                           {k: jnp.asarray(v) for k, v in params.items()},
                           0.9999, num_updates=n)
    got = {k: T(v.copy()) for k, v in ema.items()}
    tema.ema_update(got, {k: T(v) for k, v in params.items()}, 0.9999, num_updates=n)
    for k in ema:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7)


def test_loss_aware_sampler_matches_jax():
    """History FIFO, warm-up, importance weights 1/(T p_t), over updates
    that fill every timestep's history and then shift it."""
    Tn, H = 5, 3
    rng = np.random.RandomState(3)
    jstate = jres.init_loss_aware(Tn, H)
    sampler = tres.LossSecondMomentSampler(Tn, H)
    for step in range(8):
        ts = rng.randint(0, Tn, size=4) if step < 6 else np.arange(Tn)
        if step in (4, 5):
            ts = np.concatenate([np.arange(Tn), np.arange(Tn), np.arange(Tn)])
        losses = rng.rand(len(ts)).astype(np.float32) + 0.1
        jstate = jres.loss_aware_update(jstate, jnp.asarray(ts), jnp.asarray(losses))
        sampler.update(T(ts), T(losses))
        np.testing.assert_array_equal(sampler.counts.numpy(), np.asarray(jstate.counts))
        np.testing.assert_allclose(sampler.history.numpy(), np.asarray(jstate.history))
        np.testing.assert_allclose(sampler.weights().numpy(),
                                   np.asarray(jres.loss_aware_weights(jstate)), rtol=1e-6)
    assert bool((sampler.counts == H).all())  # warmed up: weights not uniform
    w = np.asarray(jres.loss_aware_weights(jstate))
    p = w / w.sum()
    t = np.array([0, 3, 3, 4])
    np.testing.assert_allclose(sampler.importance(T(t)).numpy(), 1 / (Tn * p[t]),
                               rtol=1e-6)
    draws, weights = sampler.sample(torch.Generator().manual_seed(0), 64)
    assert draws.shape == (64,) and int(draws.max()) < Tn
    np.testing.assert_allclose(weights.numpy(), 1 / (Tn * p[draws.numpy()]), rtol=1e-6)


def test_uniform_sample():
    t, w = tres.uniform_sample(torch.Generator().manual_seed(0), 1000, 64)
    assert t.dtype == torch.int64 and 0 <= int(t.min()) and int(t.max()) < 1000
    assert torch.equal(w, torch.ones(64))


@pytest.mark.parametrize("shape", [(130, 300), (2, 140, 129), (128, 128), (64,),
                                   (5, 7), (300, 1, 200)])
def test_adafactor_matches_optax(shape):
    """Three steps of ``Adafactor`` against ``optax.adafactor`` on the same
    gradients (of three magnitudes), factored and not; the update each step
    within 1e-5 of the largest (fp32 in another order)."""
    rng = np.random.RandomState(4)
    p0 = rng.randn(*shape).astype(np.float32)
    tx = optax.adafactor(learning_rate=1e-2)
    jp, jstate = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(T(p0.copy()))
    opt = toptim.Adafactor([tp], learning_rate=1e-2)
    for scale in (1.0, 30.0, 1e-3):
        g = (rng.randn(*shape) * scale).astype(np.float32)
        upd, jstate = tx.update(jnp.asarray(g), jstate, jp)
        before = np.asarray(jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = T(g)
        opt.step()
        assert_step_close(tp.detach(), jp, before, 1e-5, str(shape))


# --- the train step on the tiny UNet --------------------------------------

def _tiny_batch(seed):
    rng = np.random.RandomState(seed)
    mc = TINY_UNET
    return {
        "image_latents": rng.randn(B, LAT, LAT, 4).astype(np.float32),
        "full_emb": rng.randn(B, 7, mc["text_encoder_in_dim1"]).astype(np.float32),
        "pooled_emb": rng.randn(B, mc["text_encoder_in_dim2"]).astype(np.float32),
        "image_emb": rng.randn(B, mc["image_encoder_in_dim"]).astype(np.float32),
    }


def _jax_draws(seed, step, shape):
    """The t and noise that the JAX train step draws (train_unclip.py:140-156)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    rng_t, rng_n = jax.random.split(rng)
    t, _ = jres.uniform_sample(rng_t, 1000, shape[0])
    return np.asarray(t), np.asarray(jax.random.normal(rng_n, shape, jnp.float32))


def _torch_unet(params):
    mc = dict(jcfg.CONFIG_2_1["model_config"], **TINY_UNET)
    return load_jax_params(tcfg.create_model(**mc, dtype=torch.float32), params)


LR = 1e-3


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's loss, terms and gradient of the tiny UNet on one batch, and
    one ``make_unclip_train_step`` step (masked Adafactor, EMA)."""
    mc = dict(jcfg.CONFIG_2_1["model_config"], **TINY_UNET)
    jm = jcfg.create_model(**mc, dtype=jnp.float32)
    batch = _tiny_batch(5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    cond = {k: jb[k] for k in ("full_emb", "pooled_emb", "image_emb")}
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb["image_latents"],
                            jnp.zeros((B,)), **cond)
    params = numpy_params(shapes, 6)["params"]
    t, noise = _jax_draws(0, 0, (B, LAT, LAT, 4))
    skw = jcfg.schedule_kwargs(DCFG, "")
    jsched = jg.make_schedule(**skw["make_schedule"])

    def loss_fn(p):
        terms = jg.training_losses(
            jsched, lambda x, tm: jm.apply({"params": p}, x, tm, **cond),
            jb["image_latents"], jnp.asarray(t), jnp.asarray(noise),
            mean_type=skw["mean_type"], var_type=skw["var_type"],
            loss_type=skw["loss_type"], channel_axis=-1)
        return jnp.mean(terms["loss"]), terms

    (loss, terms), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    mask = jax_freeze_mask(params, freeze_resblocks=True)
    init_state, train_step = jax_make_step(
        jm, DCFG, masked_optimizer(optax.adafactor(learning_rate=LR), mask),
        ema_decay=0.9999)
    state, metrics = jax.jit(train_step)(init_state(params), jb, jax.random.PRNGKey(0))
    return dict(params=params, batch=batch, t=t, noise=noise, loss=loss,
                terms=terms, grads=grads, state=state, metrics=metrics, mask=mask)


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def test_freeze_mask_matches_jax(jax_ref):
    tm = _torch_unet(jax_ref["params"])
    for fr, fa in ((True, False), (False, True), (True, True)):
        want = {torch_key_for(path): bool(v) for path, v in
                flatten(jax_freeze_mask(jax_ref["params"], fr, fa)).items()}
        assert toptim.decoder_freeze_mask(tm, fr, fa) == want


def test_train_step_gradient_matches_jax(jax_ref):
    """The loss, its terms and the gradient of every parameter (the JAX
    gradient tree pushed through the weight bridge onto the port's keys).
    Tolerance 1e-4 of the largest gradient of each tensor; tensors whose
    gradient is below 1e-3 of the largest tensor's (GroupNorm over one
    channel per group makes the previous conv's bias gradient zero up to
    rounding) are held to 1e-4 of that largest instead."""
    tm = _torch_unet(jax_ref["params"])
    skw = tcfg.schedule_kwargs(DCFG, "")
    loss, terms = ttrain.unclip_loss(
        tm, tg.make_schedule(**skw["make_schedule"]), _torch_batch(jax_ref["batch"]),
        torch.tensor(jax_ref["t"]), torch.tensor(jax_ref["noise"]), torch.ones(B),
        mean_type=skw["mean_type"], var_type=skw["var_type"],
        loss_type=skw["loss_type"])
    loss.backward()
    assert_close(loss, jax_ref["loss"], MODULE_TOL, "loss")
    for k in ("loss", "mse", "vb"):
        assert_close(terms[k], jax_ref["terms"][k], MODULE_TOL, k)
    want = jax_to_state_dict(jax_ref["grads"], tm)
    top = max(float(g.abs().max()) for g in want.values())
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * scale, f"{name}: {err:.3e} > {1e-4 * scale:.3e}"


def test_one_adafactor_step_matches_jax(jax_ref):
    """One ``train_step`` with the YAML's freeze rules, Adafactor and EMA,
    JAX's t and noise injected, against ``make_unclip_train_step`` with
    ``optax.adafactor``: the frozen tensors unchanged, each trained tensor's
    update within 1e-3 of its largest, the EMA within 1e-5.  Adafactor's
    first step is g / |g| elementwise for an unfactored tensor, so where the
    gradient is rounding noise (below 1e-3 of the largest tensor's, as in
    the gradient test: a conv bias before a GroupNorm of one channel per
    group) the step's direction is noise too: there the update is only
    held to be no larger than JAX's largest."""
    tm = _torch_unet(jax_ref["params"])
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    init_state, train_step = ttrain.make_unclip_train_step(
        tm, DCFG, lambda ps: toptim.Adafactor(ps, learning_rate=LR))
    state = init_state(toptim.decoder_freeze_mask(tm, freeze_resblocks=True))
    metrics = train_step(state, _torch_batch(jax_ref["batch"]),
                         t=torch.tensor(jax_ref["t"]), noise=torch.tensor(jax_ref["noise"]))
    for k in ("loss", "mse", "vb"):
        assert_close(metrics[k], jax_ref["metrics"][k], MODULE_TOL, k)
    new = jax_to_state_dict(jax_ref["state"].params, tm)
    ema = jax_to_state_dict(jax_ref["state"].ema_params, tm)
    grads = jax_to_state_dict(jax_ref["grads"], tm)
    top = max(float(g.abs().max()) for g in grads.values())
    trainable = {torch_key_for(p): bool(v) for p, v in flatten(jax_ref["mask"]).items()}
    assert state.step == 1 and int(jax_ref["state"].step) == 1
    for name, p in tm.named_parameters():
        if not trainable[name]:
            assert torch.equal(p.detach(), before[name]), name
            assert torch.equal(new[name], before[name]), name
            continue
        if float(grads[name].abs().max()) < 1e-3 * top:
            step = (p.detach() - before[name]).abs().max()
            assert step <= (new[name] - before[name]).abs().max() * (1 + 1e-3), name
        else:
            assert_step_close(p.detach(), new[name], before[name], 1e-3, name)
            assert_close(state.ema_params[name], ema[name], 1e-5, f"ema {name}")


def _sgd_step(params, batch, t, noise, **kw):
    """Parameters after one train step with SGD at lr 1 (p - grad)."""
    tm = _torch_unet(params)
    init_state, train_step = ttrain.make_unclip_train_step(
        tm, DCFG, lambda ps: torch.optim.SGD(ps, lr=1.0), ema_decay=None, **kw)
    train_step(init_state(), _torch_batch(batch), t=torch.tensor(t),
               noise=torch.tensor(noise))
    return {n: p.detach() for n, p in tm.named_parameters()}


def test_accum_steps_and_remat_match_the_plain_step(jax_ref):
    """accum_steps=2 gives the full batch's gradient, and remat=True the
    same gradient as no remat."""
    args = (jax_ref["params"], jax_ref["batch"], jax_ref["t"], jax_ref["noise"])
    plain = _sgd_step(*args)
    accum = _sgd_step(*args, accum_steps=2)
    remat = _sgd_step(*args, remat=True)
    for name, p in plain.items():
        assert_close(accum[name], p, 1e-5, f"accum {name}")
        assert torch.equal(remat[name], p), f"remat {name}"


def _adafactor_step(jax_ref, accum_steps=1):
    """(loss, parameters, EMA) after one Adafactor step of the tiny UNet on
    ``jax_ref``'s batch, t and noise."""
    tm = _torch_unet(jax_ref["params"])
    init_state, train_step = ttrain.make_unclip_train_step(
        tm, DCFG, lambda ps: toptim.Adafactor(ps, learning_rate=LR), accum_steps=accum_steps)
    state = init_state(toptim.decoder_freeze_mask(tm, freeze_resblocks=True))
    metrics = train_step(state, _torch_batch(jax_ref["batch"]),
                         t=torch.tensor(jax_ref["t"]), noise=torch.tensor(jax_ref["noise"]))
    return metrics["loss"], dict(tm.named_parameters()), state.ema_params


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_opens_its_spans_and_the_profiler_changes_nothing(jax_ref, accum_steps):
    """A step opens ``train.forward`` and ``train.backward`` once a
    microbatch and ``train.ema`` once; under the profiler its loss, its
    parameters and their EMA are bitwise those of the step without it."""
    (loss, params, ema), spans = profiled_spans(lambda: _adafactor_step(jax_ref, accum_steps))
    counts = {n: len(spans.get(n, [])) for n in ("train.forward", "train.backward", "train.ema")}
    assert counts == {"train.forward": accum_steps, "train.backward": accum_steps,
                      "train.ema": 1}
    loss0, params0, ema0 = _adafactor_step(jax_ref, accum_steps)
    assert torch.equal(loss, loss0)
    for name, p in params.items():
        assert torch.equal(p, params0[name]) and torch.equal(ema[name], ema0[name]), name


# --- loop, checkpoint and CLI ---------------------------------------------

def _loop(params, batches, save_path, save_every):
    return ttrain.train_unclip(
        unet=_torch_unet(params), diffusion_config=DCFG, loader=batches,
        prepare_batch=_torch_batch, schedule_sampler="loss-second-moment",
        save_every=save_every, save_path=str(save_path), log_every=1000,
        freeze_resblocks=True)


def test_kill_and_resume_is_bitwise_identical(jax_ref, tmp_path):
    """Four steps in one run against two, a save, a fresh process-like
    restart from the saved state and two more: params, EMA, optimizer
    state, sampler history, step and generator all equal bitwise."""
    batches = [_tiny_batch(10 + i) for i in range(4)]
    straight = _loop(jax_ref["params"], batches, tmp_path / "straight", 1000)
    _loop(jax_ref["params"], batches[:2], tmp_path / "resumed", 2)
    fname, step = tckpt.latest_train_state(str(tmp_path / "resumed"))
    assert step == 2 and fname.endswith("state_00000002.pt")
    resumed = _loop(jax_ref["params"], batches[2:], tmp_path / "resumed", 1000)
    assert straight.step == resumed.step == 4
    a, b = straight.state_dict(), resumed.state_dict()
    flat = lambda sd: {k: v for k, v in flatten({"s": {
        "params": sd["params"], "ema": sd["ema"], "sampler": sd["sampler"],
        "opt": {str(i): s for i, s in sd["optimizer"]["state"].items()}}}).items()}
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(torch.as_tensor(fa[k]), torch.as_tensor(fb[k])), k
    assert torch.equal(a["generator"], b["generator"])
    export, step = tckpt.latest_checkpoint(str(tmp_path / "resumed"))
    assert step == 4
    for k, v in tckpt.load_checkpoint(export).items():
        assert torch.equal(v, a["params"][k]), k


def test_restore_rejects_structure_drift(jax_ref, tmp_path):
    tm = _torch_unet(jax_ref["params"])
    init_state, _ = ttrain.make_unclip_train_step(tm, DCFG, ema_decay=None)
    state = init_state()
    fname = tckpt.save_train_state(str(tmp_path), state, 1)
    init_other, _ = ttrain.make_unclip_train_step(tm, DCFG, ema_decay=0.999)
    with pytest.raises(ValueError, match="structure"):
        tckpt.restore_train_state(fname, init_other())
    tckpt.restore_train_state(fname, state)  # a faithful template restores


@pytest.mark.parametrize("inpainting", [False, True])
def test_cli_on_a_tiny_yaml(tmp_path, inpainting):
    """``python -m kandinsky2_tpu_torch.train.train_2_1_unclip --config``
    on a YAML of the small widths, seeded 64² PNGs and a CSV: two steps of
    batch 2, the whole state and the weights saved at step 2; with
    ``inpainting: true`` the 9-channel UNet trains on masked latents."""
    import yaml
    from PIL import Image

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
    cfg["inpainting"] = inpainting
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    np.random.seed(3)  # the masks' draws
    tcli.main(["--config", str(tmp_path / "tiny.yaml"), "--device", "cpu"])
    assert tckpt.latest_train_state(str(tmp_path / "ckpt"))[1] == 2
    fname, step = tckpt.latest_checkpoint(str(tmp_path / "ckpt"))
    assert step == 2
    weights = tckpt.load_checkpoint(fname)
    assert weights["input_blocks.0.0.weight"].shape[1] == (9 if inpainting else 4)
    assert all(torch.isfinite(v).all() for v in weights.values())


def test_inpainting_batch_and_step_match_jax(tmp_path):
    """The masks of the inpainting CLI's batches (``get_image_mask`` at the
    latents' size from the global generator) as the JAX package draws
    them, and one inpainting step of the tiny 9-channel UNet with JAX's t,
    noise and masks: the loss, its terms and every gradient against
    JAX's (1e-4)."""
    from kandinsky2_tpu.train.masks import get_image_mask as jax_masks
    from kandinsky2_tpu_torch.train.masks import get_image_mask

    np.random.seed(21)
    masks = jax_masks(B, (LAT, LAT))[..., None].astype(np.float32)
    np.random.seed(21)
    assert (get_image_mask(B, (LAT, LAT))[..., None] == masks).mean() >= 0.99
    assert 0 < masks.mean() < 1

    mc = dict(jcfg.CONFIG_2_1["model_config"], **TINY_UNET, inpainting=True)
    jm = jcfg.create_model(**mc, dtype=jnp.float32)
    batch = _tiny_batch(15)
    batch["inpaint_mask"] = masks
    batch["inpaint_image"] = batch["image_latents"] * masks
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    kw = {k: jb[k] for k in ("full_emb", "pooled_emb", "image_emb", "inpaint_image",
                             "inpaint_mask")}
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb["image_latents"],
                            jnp.zeros((B,)), **kw)
    params = numpy_params(shapes["params"], 16)
    t, noise = _jax_draws(0, 0, (B, LAT, LAT, 4))
    skw = jcfg.schedule_kwargs(DCFG, "")

    def loss_fn(p):
        terms = jg.training_losses(
            jg.make_schedule(**skw["make_schedule"]),
            lambda x, tm: jm.apply({"params": p}, x, tm, **kw), jb["image_latents"],
            jnp.asarray(t), jnp.asarray(noise), mean_type=skw["mean_type"],
            var_type=skw["var_type"], loss_type=skw["loss_type"], channel_axis=-1)
        return jnp.mean(terms["loss"]), terms

    (loss, terms), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    init_state, step = jax_make_step(jm, DCFG, optax.sgd(LR), inpainting=True,
                                     ema_decay=None)
    _, jmetrics = jax.jit(step)(init_state(params), jb, jax.random.PRNGKey(0))

    tm = load_jax_params(tcfg.create_model(**mc, dtype=torch.float32), params)
    tskw = tcfg.schedule_kwargs(DCFG, "")
    tsched = tg.make_schedule(**tskw["make_schedule"])
    got, got_terms = ttrain.unclip_loss(
        tm, tsched, _torch_batch(batch), torch.tensor(t), torch.tensor(noise),
        torch.ones(B), mean_type=tskw["mean_type"], var_type=tskw["var_type"],
        loss_type=tskw["loss_type"])
    got.backward()
    assert_close(got, loss, MODULE_TOL, "loss")
    assert_close(got, jmetrics["loss"], MODULE_TOL, "the JAX step's loss")
    for k in ("mse", "vb"):
        assert_close(got_terms[k], terms[k], MODULE_TOL, k)
    want = jax_to_state_dict(grads, tm)
    top = max(float(g.abs().max()) for g in want.values())
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * scale, f"{name}: {err:.3e} > {1e-4 * scale:.3e}"
    # the inpainting inputs reach the UNet: another mask, another loss
    other = dict(_torch_batch(batch), inpaint_mask=torch.ones(B, LAT, LAT, 1))
    with torch.no_grad():
        moved, _ = ttrain.unclip_loss(
            tm, tsched, other, torch.tensor(t), torch.tensor(noise), torch.ones(B),
            mean_type=tskw["mean_type"], var_type=tskw["var_type"],
            loss_type=tskw["loss_type"])
    assert abs(float(moved) - float(got.detach())) > 1e-6


@pytest.mark.parametrize("change", [
    {"parallel": "fsdp"},
    {"optim_params": {"name": "optax.lion", "params": {"learning_rate": 1e-4}}},
    {"optim_params": {"name": "optax.adamw",
                      "params": {"learning_rate": 1e-4, "mask": {"kernel": True}}}},
])
def test_run_rejects_what_the_port_lacks(change):
    """``run`` refuses, before building anything, a YAML whose ``parallel``
    is not a mapping (TypeError), an optimizer other than optax's
    adafactor, adam, adamw and sgd, or a mask over the JAX parameter tree
    (NotImplementedError)."""
    cfg = dict(tcli.small_train_config("", "", ""), **change)
    with pytest.raises(TypeError if "parallel" in change else NotImplementedError):
        tcli.run(cfg, device="cpu")


def test_run_trains_with_adamw(tmp_path):
    """``run`` on the tiny YAML with ``optax.adamw`` at 1e-4: two steps of
    optax's AdamW (decay 1e-4) over the trainable tensors only, each moved,
    with two fp32 moments of its shape and the step count 2."""
    from PIL import Image

    rng = np.random.RandomState(9)
    (tmp_path / "img").mkdir()
    rows = ["image_name,caption"]
    for i in range(4):
        Image.fromarray(rng.randint(0, 256, (64, 64, 3), np.uint8)).save(
            tmp_path / "img" / f"{i}.png")
        rows.append(f"{i}.png,a seeded picture {i}")
    (tmp_path / "data.csv").write_text("\n".join(rows) + "\n")
    cfg = tcli.small_train_config(str(tmp_path / "data.csv"), str(tmp_path / "img"),
                                  str(tmp_path / "ckpt"))
    cfg["optim_params"] = {"name": "optax.adamw", "params": {"learning_rate": 1e-4}}
    before = {n: p.detach().clone() for n, p in tcli.build_pipeline(cfg, "cpu")
              .unet.named_parameters()}
    state = tcli.run(cfg, device="cpu")
    opt = state.optimizer
    assert state.step == 2 and isinstance(opt, toptim.Adam)
    assert opt.param_groups[0]["weight_decay"] == 1e-4
    trained = [p for p in state.model.parameters() if p.requires_grad]
    assert 0 < len(trained) < len(before) and len(opt.state) == len(trained)
    for p in trained:
        s = opt.state[p]
        assert s["step"] == 2 and s["mu"].dtype == s["nu"].dtype == torch.float32
        assert s["mu"].shape == s["nu"].shape == p.shape
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), before[name]) != p.requires_grad, name


def test_loader_batches_match_jax(tmp_path):
    """The port's dataset and loader give the JAX package's batches: the same
    shuffles, CFG drops, images, CLIP crops, tokens and masks."""
    from PIL import Image

    from kandinsky2_tpu.train import data as jdata
    from kandinsky2_tpu_torch.train import data as tdata

    rng = np.random.RandomState(12)
    rows = ["image_name,caption"]
    for i in range(6):
        Image.fromarray(rng.randint(0, 256, (40 + 8 * i, 48, 3), np.uint8)).save(
            tmp_path / f"{i}.png")
        rows.append(f"{i}.png,picture number {i} of six")
    (tmp_path / "data.csv").write_text("\n".join(rows) + "\n")
    kw = dict(csv_path=str(tmp_path / "data.csv"), image_dir=str(tmp_path),
              tokenizer=stub_tokenizers(64)[0], clip_image_size=28, image_size=32,
              drop_text_prob=0.5, drop_image_prob=0.3, seq_len=12)
    loaders = [lib.create_loader(lib.TextImageDataset(**kw), batch_size=2)
               for lib in (tdata, jdata)]
    for _ in range(2):  # two epochs: the reshuffle and the drops go on alike
        got, want = (list(loader) for loader in loaders)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
