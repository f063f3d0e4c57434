"""The port's LoRA (``kandinsky2_tpu_torch/models/lora.py``) and LoRA
fine-tuning step (``train/train_lora.py``) against the JAX package's, in
fp32 on the CPU, on ``tests/test_pipeline22.py``'s TINY 2.2 UNet with
64-wide heads, numpy-seeded parameters and the added-KV attention on K3's
route (the flash kernels' plain versions, forward and backward).

JAX's factors cannot be drawn by torch, so they are carried across
(``lora_from_jax``), with ``up`` made non-zero where a test needs a
gradient in ``down``; each step takes the t and noise the JAX step draws
from its key."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kandinsky2_tpu.models import lora as jlora
from kandinsky2_tpu.models import unet22 as junet22
from kandinsky2_tpu.train import train_lora as jtrain
from kandinsky2_tpu_torch.models import lora as tlora
from kandinsky2_tpu_torch.models import unet22 as tunet22
from kandinsky2_tpu_torch.train import checkpoint as tckpt
from kandinsky2_tpu_torch.train import train_lora as ttrain
from kandinsky2_tpu_torch.weights.from_jax import (
    jax_to_state_dict,
    load_jax_params,
    lora_from_jax,
    torch_key_for,
)
from test_torch_common import flash_route, numpy_params, tiny22

T = lambda a: torch.from_numpy(np.array(a))
WIDE = tiny22(64)["unet"]
B, LAT, T_STEPS, LR = 2, 8, 1000, 1e-3
ACP = np.cumprod(1.0 - np.linspace(0.00085, 0.012, T_STEPS)).astype(np.float32)


def rel_l2(got, want) -> float:
    got = np.concatenate([np.asarray(g, np.float64).ravel() for g in got])
    want = np.concatenate([np.asarray(w, np.float64).ravel() for w in want])
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def jax_draws(key, shape):
    """t and noise as ``make_lora_train_step`` draws them from ``key``."""
    rng_t, rng_n = jax.random.split(key)
    t = jax.random.randint(rng_t, (shape[0],), 0, T_STEPS)
    return np.asarray(t), np.asarray(jax.random.normal(rng_n, shape, jnp.float32))


def _factors(loras, order):
    return [f[k] for _, f in sorted(loras.items()) for k in order]


@pytest.fixture(scope="module")
def pair():
    """JAX and port UNet22 on the same parameters, JAX's rank-2 factors
    with seeded non-zero ``up``, and a seeded batch."""
    ju = junet22.UNet22(**WIDE)
    shapes = jax.eval_shape(ju.init, jax.random.PRNGKey(0), jnp.zeros((1, LAT, LAT, 4)),
                            jnp.zeros((1,)), jnp.zeros((1, WIDE["encoder_hid_dim"])))
    params = numpy_params(shapes["params"], 31)
    tu = load_jax_params(tunet22.UNet22(**WIDE), params)
    loras = jlora.init_lora(params, jax.random.PRNGKey(0), rank=2)
    rng = np.random.RandomState(32)
    for f in loras.values():
        f["up"] = jnp.asarray(0.05 * rng.randn(*f["up"].shape).astype(np.float32))
    x0 = (0.5 * rng.randn(B, LAT, LAT, 4)).astype(np.float32)
    cond = rng.randn(B, WIDE["encoder_hid_dim"]).astype(np.float32)
    return dict(ju=ju, tu=tu, params=params, loras=loras, x0=x0, cond=cond)


def test_default_target_selects_jax_tensors(pair):
    """The same weights, through ``torch_key_for``, and the same factor
    shapes; ``up`` starts at zero and ``down`` at unit scale / √in."""
    want = jlora.init_lora(pair["params"], jax.random.PRNGKey(0), rank=4)
    got = tlora.init_lora(pair["tu"], torch.Generator().manual_seed(0), rank=4)
    assert set(got) == {torch_key_for(p) for p in want} and len(got) == 36
    for path, f in want.items():
        g = got[torch_key_for(path)]
        assert tuple(g["down"].shape) == f["down"].shape
        assert tuple(g["up"].shape) == f["up"].shape
        assert g["up"].abs().max() == 0 and g["down"].dtype == torch.float32
        assert 0.5 < float(g["down"].std() * g["down"].shape[0] ** 0.5) < 1.5


def test_merge_and_unmerge_match_jax(pair):
    """W + 0.7·(down @ up)ᵀ on every factored weight, the rest untouched,
    against ``merge_lora`` through the bridge (1e-6); unmerging returns the
    base."""
    tu = pair["tu"]
    base = {n: p.detach() for n, p in tu.named_parameters()}
    loras = lora_from_jax(pair["loras"])
    merged = tlora.merge_lora(base, loras, scale=0.7)
    want = jax_to_state_dict(jlora.merge_lora(pair["params"], pair["loras"], 0.7), tu)
    assert set(merged) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(merged[name].numpy(), w.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
        if name not in loras:
            assert merged[name] is base[name]
    back = tlora.unmerge_lora(merged, loras, scale=0.7)
    for name, w in base.items():
        np.testing.assert_allclose(back[name].numpy(), w.numpy(), rtol=0, atol=1e-6)


def _port_state(pair, loras=None, seed=0):
    loras = lora_from_jax(pair["loras"]) if loras is None else loras
    return ttrain.init_lora_train_state(
        loras, lambda ps: torch.optim.Adam(ps, lr=LR), seed=seed)


def _port_step(pair):
    return ttrain.make_lora_train_step(ttrain.unet22_eps_fn(pair["tu"]), pair["tu"], ACP)


def test_one_step_and_three_adam_steps_match_jax(monkeypatch, pair):
    """Step 1: the loss and the gradient of every factor (captured before
    the update) against JAX's ``value_and_grad`` of its step's loss, 1e-4
    relative L2.  Then three steps of ``make_lora_train_step`` with
    ``optax.adam(1e-3)`` and JAX's draws: each step's loss 1e-4, the
    factors' total update 1e-3 relative L2."""
    calls = flash_route(monkeypatch)
    keys = [jax.random.PRNGKey(40 + i) for i in range(3)]
    draws = [jax_draws(k, pair["x0"].shape) for k in keys]
    ju, params = pair["ju"], pair["params"]
    jeps = jtrain.unet22_eps_fn(ju)
    acp = jnp.asarray(ACP)

    def jloss(loras, t, noise):
        a = acp[t].reshape((B, 1, 1, 1))
        x_t = jnp.sqrt(a) * pair["x0"] + jnp.sqrt(1.0 - a) * noise
        eps = jeps(jlora.merge_lora(params, loras), x_t, t.astype(jnp.float32),
                   jnp.asarray(pair["cond"]))
        return jnp.mean((eps.astype(jnp.float32) - noise) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(pair["loras"], *draws[0])

    tx = optax.adam(LR)
    jstep = jtrain.make_lora_train_step(jeps, params, ACP, tx)
    jstate = jtrain.init_lora_train_state(
        jax.tree_util.tree_map(jnp.array, pair["loras"]), tx)
    jlosses = []
    for k in keys:
        jstate, m = jstep(jstate, jnp.asarray(pair["x0"]), jnp.asarray(pair["cond"]), k)
        jlosses.append(float(m["loss"]))

    state = _port_state(pair)
    before = {n: {k: v.detach().clone() for k, v in f.items()}
              for n, f in ttrain.nest_loras(state.params).items()}
    grads = []
    hook = state.optimizer.register_step_pre_hook(lambda opt, a, kw: grads.append(
        {n: {k: v.grad.clone() for k, v in f.items()}
         for n, f in ttrain.nest_loras(state.params).items()}))
    step = _port_step(pair)
    losses = [float(step(state, T(pair["x0"]), T(pair["cond"]), t=T(t), noise=T(n))["loss"])
              for t, n in draws]
    hook.remove()
    assert len(calls) == 3 * 6  # the 6 added-KV attentions took K3's route
    assert abs(losses[0] - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    g = lora_from_jax(want_grads)
    assert rel_l2(_factors(grads[0], ("down", "up")), _factors(g, ("down", "up"))) <= 1e-4
    start = _factors(before, ("down", "up"))
    factors = _factors(ttrain.nest_loras(state.params), ("down", "up"))
    got = [v.detach() - b for v, b in zip(factors, start)]
    want = [v - b for v, b in zip(_factors(lora_from_jax(jstate.loras), ("down", "up")),
                                  start)]
    assert state.step == 3
    assert rel_l2(got, want) <= 1e-3


def test_loss_falls_and_the_base_never_moves(pair):
    """Factors from ``init_lora`` (up = 0), 30 steps of Adam at 1e-3 on one
    fixed draw: the loss falls below 0.9 of its start, the UNet's own
    parameters stay bitwise as they were, and the up factors move."""
    tu = pair["tu"]
    base = {n: p.detach().clone() for n, p in tu.named_parameters()}
    loras = tlora.init_lora(tu, torch.Generator().manual_seed(1), rank=2)
    state = _port_state(pair, loras)
    step = _port_step(pair)
    t, noise = jax_draws(jax.random.PRNGKey(7), pair["x0"].shape)
    losses = [float(step(state, T(pair["x0"]), T(pair["cond"]), t=T(t),
                         noise=T(noise))["loss"]) for _ in range(30)]
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.9 * losses[0], losses
    for n, p in tu.named_parameters():
        assert torch.equal(p.detach(), base[n]) and p.grad is None, n
    assert all(float(f["up"].detach().abs().max()) > 0
               for f in ttrain.nest_loras(state.params).values())


def test_lora_state_resumes_bitwise(pair, tmp_path):
    """Six steps drawing from the state's generator, against three, a save,
    a fresh state restored from it and three more: factors, optimizer
    state, step and generator bitwise equal."""
    step = _port_step(pair)
    x0, cond = T(pair["x0"]), T(pair["cond"])

    def run(state, n):
        for _ in range(n):
            step(state, x0, cond)
        return state

    straight = run(_port_state(pair, seed=5), 6)
    fname = tckpt.save_train_state(str(tmp_path), run(_port_state(pair, seed=5), 3))
    resumed = _port_state(pair, seed=123)
    tckpt.restore_train_state(fname, resumed)
    run(resumed, 3)
    a, b = straight.state_dict(), resumed.state_dict()
    assert a["step"] == b["step"] == 6 and torch.equal(a["generator"], b["generator"])
    assert set(a["params"]) == set(ttrain.flatten_loras(lora_from_jax(pair["loras"])))
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    for i, s in a["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(b["optimizer"]["state"][i][k])), (i, k)
    with pytest.raises(ValueError, match="structure"):
        _port_state(pair, loras={k: v for k, v in list(lora_from_jax(
            pair["loras"]).items())[:3]}).load_state_dict(a)
