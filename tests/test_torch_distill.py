"""The port's progressive step distillation (``kandinsky2_tpu_torch/train/
distill.py``) against the JAX package's ``train/distill.py``, in fp32 on
the CPU: the ladder guards, the trained timesteps on the student's
inference ladder, and one step on ``tests/test_pipeline22.py``'s TINY 2.2
UNet with 64-wide heads (numpy-seeded teacher, the added-KV attention on
K3's route) with the JAX step's draws: the teacher's x0 target, the loss
and the student's gradient.  JAX's target and gradient are computed with
its own ``unet22_eps_fn`` and the formulas of ``distill.py:87-120``, its
loss by ``make_distill_step`` itself."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kandinsky2_tpu.models import unet22 as junet22
from kandinsky2_tpu.train import distill as jdistill
from kandinsky2_tpu.train.train_lora import unet22_eps_fn as jeps_fn
from kandinsky2_tpu_torch.diffusion.paired import ddpm_ladder
from kandinsky2_tpu_torch.models import unet22 as tunet22
from kandinsky2_tpu_torch.train import distill as tdistill
from kandinsky2_tpu_torch.train.train_lora import unet22_eps_fn
from kandinsky2_tpu_torch.weights.from_jax import jax_to_state_dict, load_jax_params
from test_torch_common import flash_route, numpy_params, tiny22

T = lambda a: torch.from_numpy(np.array(a))
WIDE = tiny22(64)["unet"]
B, LAT, S = 2, 8, 250
ACP = np.cumprod(1.0 - np.linspace(0.00085, 0.012, 1000)).astype(np.float32)


def _toy(calls=None):
    """A differentiable stand-in for the UNet: eps = w·x (+ t recorded)."""
    def eps_fn(params, x, t, cond):
        if calls is not None:
            calls.append(t.long().tolist())
        return params["w"] * x
    return eps_fn


@pytest.mark.parametrize("num_student_steps", [1, 2, 3, 250, 300, 500, 999, 1000])
def test_ladder_guards_raise_where_jax_does(num_student_steps):
    kw = dict(num_student_steps=num_student_steps)

    def raised(make, *args):
        try:
            make(*args, **kw)
        except ValueError as e:
            return str(e)
        return None

    want = raised(jdistill.make_distill_step, lambda *a: None, {}, ACP, optax.adam(1e-4))
    got = raised(tdistill.make_distill_step, _toy(), {"w": torch.ones(())}, ACP)
    assert got == want


@pytest.mark.parametrize("num_student_steps", [125, 200, 250, 500])
def test_ladder_guards_follow_the_schedule_length(num_student_steps):
    """The port reads the number of train steps from ``alphas_cumprod``'s
    length; on a 500-step schedule it raises where JAX's step given
    ``num_train_steps=500`` does, with the same message."""
    acp = ACP[:500]

    def raised(make, *args, **kw):
        try:
            make(*args, num_student_steps=num_student_steps, **kw)
        except ValueError as e:
            return str(e)
        return None

    want = raised(jdistill.make_distill_step, lambda *a: None, {}, acp, optax.adam(1e-4),
                  num_train_steps=500)
    got = raised(tdistill.make_distill_step, _toy(), {"w": torch.ones(())}, acp)
    assert got == want


def test_distill_state_resumes_bitwise(tmp_path):
    """Six toy steps drawing from the state's generator, against three, a
    save, a fresh state restored from it and three more: student, Adam
    state, step and generator bitwise equal; a student of another shape is
    refused."""
    from kandinsky2_tpu_torch.train import checkpoint as tckpt

    teacher = {"w": torch.tensor([0.5, 0.7])}
    step = tdistill.make_distill_step(_toy(), teacher, ACP, num_student_steps=S)
    x0 = torch.randn(4, 4, 4, 2, generator=torch.Generator().manual_seed(1))
    new = lambda seed, params=teacher: tdistill.init_distill_state(
        params, lambda ps: torch.optim.Adam(ps, lr=1e-2), seed=seed)

    def run(state, n):
        for _ in range(n):
            step(state, x0, None)
        return state

    straight = run(new(5), 6)
    resumed = new(9)
    tckpt.restore_train_state(tckpt.save_train_state(str(tmp_path), run(new(5), 3)),
                              resumed)
    run(resumed, 3)
    a, b = straight.state_dict(), resumed.state_dict()
    assert a["step"] == b["step"] == 6 and torch.equal(a["generator"], b["generator"])
    assert torch.equal(a["params"]["w"], b["params"]["w"])
    assert not torch.equal(a["params"]["w"], teacher["w"])
    for k, v in a["optimizer"]["state"][0].items():
        assert torch.equal(torch.as_tensor(v), torch.as_tensor(b["optimizer"]["state"][0][k]))
    with pytest.raises(ValueError, match="structure"):
        new(0, {"w": torch.ones(3)}).load_state_dict(a)


def test_trained_timesteps_lie_on_the_inference_ladder():
    """The student's t (drawn by the step) is 2·d·i with i in [1, S), so
    it lies on ``ddpm_ladder(S)``; the teacher runs at t and t − d."""
    calls = []
    step = tdistill.make_distill_step(_toy(calls), {"w": torch.tensor(0.5)}, ACP,
                                      num_student_steps=S)
    state = tdistill.init_distill_state({"w": torch.tensor(0.5)},
                                        lambda ps: torch.optim.SGD(ps, lr=1e-3))
    x0 = torch.randn(16, 4, 4, 4, generator=torch.Generator().manual_seed(0))
    for _ in range(20):
        step(state, x0, None)
    ladder = set(int(t) for t in ddpm_ladder(S))
    d = 1000 // (2 * S)
    for teacher, teacher_mid, student in zip(calls[0::3], calls[1::3], calls[2::3]):
        assert teacher == student and set(student) <= ladder and 0 not in student
        assert teacher_mid == [t - d for t in student]
    assert len({t for c in calls[2::3] for t in c}) > 100  # the draws spread


@pytest.fixture(scope="module")
def pair():
    ju = junet22.UNet22(**WIDE)
    shapes = jax.eval_shape(ju.init, jax.random.PRNGKey(0), jnp.zeros((1, LAT, LAT, 4)),
                            jnp.zeros((1,)), jnp.zeros((1, WIDE["encoder_hid_dim"])))
    params = numpy_params(shapes["params"], 41)
    tu = load_jax_params(tunet22.UNet22(**WIDE), params)
    rng = np.random.RandomState(42)
    x0 = (0.5 * rng.randn(B, LAT, LAT, 4)).astype(np.float32)
    cond = rng.randn(B, WIDE["encoder_hid_dim"]).astype(np.float32)
    return dict(ju=ju, tu=tu, params=params, x0=x0, cond=cond)


def test_one_step_matches_jax(monkeypatch, pair):
    """One step at num_student_steps = 250 with JAX's i and noise: the x0
    target, the loss and every student gradient within 1e-4 (relative L2
    over all tensors for the gradient)."""
    calls = flash_route(monkeypatch)
    key = jax.random.PRNGKey(9)
    rng_t, rng_n = jax.random.split(key)
    i = np.asarray(jax.random.randint(rng_t, (B,), 1, S))
    noise = np.asarray(jax.random.normal(rng_n, pair["x0"].shape, jnp.float32))
    d = 1000 // (2 * S)
    t = i * 2 * d
    params, x0 = pair["params"], jnp.asarray(pair["x0"])
    cond = jnp.asarray(pair["cond"])
    eps_fn = jeps_fn(pair["ju"])
    acp = jnp.asarray(ACP)
    a = lambda tt: acp[tt].reshape((-1, 1, 1, 1))

    def ddim(p, x, tt, tn):
        eps = eps_fn(p, x, tt.astype(jnp.float32), cond).astype(jnp.float32)
        x0_ = (x - jnp.sqrt(1.0 - a(tt)) * eps) / jnp.sqrt(a(tt))
        return jnp.sqrt(a(tn)) * x0_ + jnp.sqrt(1.0 - a(tn)) * eps

    def jax_loss(student):
        a_t, a_n = a(t), a(t - 2 * d)
        x_t = jnp.sqrt(a_t) * x0 + jnp.sqrt(1.0 - a_t) * noise
        z = ddim(params, ddim(params, x_t, t, t - d), t - d, t - 2 * d)
        ratio = jnp.sqrt((1.0 - a_n) / (1.0 - a_t))
        target = (z - ratio * x_t) / (jnp.sqrt(a_n) - ratio * jnp.sqrt(a_t))
        eps_s = eps_fn(student, x_t, t.astype(jnp.float32), cond)
        x0_s = (x_t - jnp.sqrt(1.0 - a_t) * eps_s.astype(jnp.float32)) / jnp.sqrt(a_t)
        w = jnp.maximum(1.0, a_t / (1.0 - a_t))
        return jnp.mean(w * (x0_s - jax.lax.stop_gradient(target)) ** 2), (target, x_t)

    (loss, (target, x_t)), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params)
    tx = optax.adam(1e-4)
    jstep = jdistill.make_distill_step(eps_fn, params, ACP, tx, num_student_steps=S)
    _, jm = jstep(jdistill.init_distill_state(params, tx), x0, cond, key)
    assert abs(float(jm["loss"]) - float(loss)) <= 1e-4 * float(loss)

    tu = pair["tu"]
    teacher = {n: p.detach() for n, p in tu.named_parameters()}
    teps = unet22_eps_fn(tu)
    got_target = tdistill.teacher_x0_target(
        teps, teacher, torch.from_numpy(ACP), T(x_t), torch.from_numpy(t), d, T(cond))
    np.testing.assert_allclose(got_target.numpy(), np.asarray(target), rtol=1e-4,
                               atol=1e-4 * float(np.abs(target).max()))

    state = tdistill.init_distill_state(teacher, lambda ps: torch.optim.Adam(ps, lr=1e-4))
    captured = {}
    state.optimizer.register_step_pre_hook(lambda opt, a, kw: captured.update(
        {n: p.grad.clone() for n, p in state.params.items()}))
    step = tdistill.make_distill_step(teps, teacher, ACP, num_student_steps=S)
    m = step(state, T(pair["x0"]), T(pair["cond"]), i=T(i), noise=T(noise))
    # the target's two teacher calls, then the step's two and the student's,
    # each with 6 added-KV attentions on K3's route
    assert len(calls) == 5 * 6
    assert float(m["loss"]) > 0
    for want_loss in (loss, jm["loss"]):
        assert abs(float(m["loss"]) - float(want_loss)) <= 1e-4 * float(want_loss)
    want = jax_to_state_dict(grads, tu)
    num = sum(float(((captured[n] - w) ** 2).sum()) for n, w in want.items())
    den = sum(float((w ** 2).sum()) for w in want.values())
    assert (num / den) ** 0.5 <= 1e-4
    for n, p in tu.named_parameters():  # the teacher is the module's, untouched
        assert torch.equal(p.detach(), teacher[n])
    assert state.step == 1 and any(not torch.equal(state.params[n], teacher[n])
                                   for n in teacher)
