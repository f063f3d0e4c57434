"""The port's optimizers (``kandinsky2_tpu_torch/train/optim.py``
``optimizer_from_config``) against optax 0.2.6 on the CPU.

Every case runs five steps of ``tx.update`` under ``jax.jit`` (as the JAX
trainers run it) and of the port's optimizer on the same numpy-seeded
parameters and gradients, the flax layouts (IO, HWIO) transposed to
torch's (OI, OIHW): a factored linear kernel, a factored 4-D conv kernel,
a vector and an unfactored matrix.  Each parameter and each fp32 state
tensor within 1e-6 relative L2; a moment kept in bf16 within one bf16
rounding of optax's (2^-8 relative L2): the linear kernel's agree
bitwise, but where the two layouts sum a conv kernel's factored moments
in another order, the fp32 values it rounds differ in their last bits and
a few of its 165,888 values round apart.  Then a bitwise resume
from a saved ``state_dict`` mid-run, the refusals, and the decoder step
with ``optax.adamw`` on the tiny UNet against JAX's.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kandinsky2_tpu import configs as jcfg
from kandinsky2_tpu.train.train_unclip import (
    decoder_freeze_mask as jax_freeze_mask,
    make_unclip_train_step as jax_make_step,
    masked_optimizer,
)
from kandinsky2_tpu_torch.train import optim as toptim
from kandinsky2_tpu_torch.train import train_unclip as ttrain
from kandinsky2_tpu_torch.train.precision import fp32_master_optimizer
from kandinsky2_tpu_torch.train.tensor_state import init_tensor_state
from kandinsky2_tpu_torch.weights.from_jax import flatten, jax_to_state_dict, torch_key_for
from test_torch_common import MODULE_TOL, TINY_UNET, assert_close
from test_torch_train import (
    DCFG,
    _jax_draws,
    _tiny_batch,
    _torch_batch,
    _torch_unet,
    assert_step_close,
    jax_ref,  # noqa: F401  (the module fixture: the tiny UNet's parameters)
)

STEPS = 5
TOL = 1e-6
# flax shape and the permutation that gives torch's layout
SHAPES = {
    "linear": ((130, 160), (1, 0)),           # IO -> OI, factored
    "conv": ((3, 3, 128, 144), (3, 2, 0, 1)),  # HWIO -> OIHW, factored
    "vector": ((64,), (0,)),
    "small": ((5, 7), (1, 0)),                # unfactored
}

CASES = {
    "adafactor": ("optax.adafactor", {"learning_rate": 1e-2}),
    "adafactor-unfactored": ("optax.adafactor", {"learning_rate": 1e-2, "factored": False}),
    "adafactor-momentum": ("optax.adafactor", {"learning_rate": 1e-2, "momentum": 0.9}),
    "adafactor-momentum-bf16": ("optax.adafactor", {
        "learning_rate": 1e-2, "momentum": 0.9, "dtype_momentum": "bfloat16"}),
    "adafactor-weight-decay": ("optax.adafactor", {
        "learning_rate": 1e-2, "weight_decay_rate": 1e-2}),
    "adafactor-no-clipping": ("optax.adafactor", {
        "learning_rate": 1e-2, "clipping_threshold": None}),
    "adafactor-clipping-2": ("optax.adafactor", {
        "learning_rate": 1e-2, "clipping_threshold": 2.0}),
    "adafactor-absolute-step": ("optax.adafactor", {
        "learning_rate": 1e-2, "multiply_by_parameter_scale": False}),
    "adafactor-decay": ("optax.adafactor", {
        "learning_rate": 1e-2, "decay_rate": 0.7, "decay_offset": -3, "eps": 1e-20,
        "min_dim_size_to_factor": 140}),
    "adafactor-no-learning-rate": ("optax.adafactor", {}),
    "adam": ("optax.adam", {"learning_rate": 1e-3}),
    "adam-betas": ("optax.adam", {"learning_rate": 1e-3, "b1": 0.8, "b2": 0.99,
                                  "eps": 1e-6}),
    "adam-eps-root": ("optax.adam", {"learning_rate": 1e-3, "eps_root": 1e-4}),
    "adam-nesterov": ("optax.adam", {"learning_rate": 1e-3, "nesterov": True}),
    "adam-mu-bf16": ("optax.adam", {"learning_rate": 1e-3, "mu_dtype": "bfloat16"}),
    "adamw": ("optax.adamw", {"learning_rate": 1e-3}),
    "adamw-decay-nesterov": ("optax.adamw", {"learning_rate": 1e-3, "weight_decay": 0.1,
                                             "nesterov": True}),
    "sgd": ("optax.sgd", {"learning_rate": 1e-2}),
    "sgd-momentum": ("optax.sgd", {"learning_rate": 1e-2, "momentum": 0.9}),
    "sgd-nesterov": ("optax.sgd", {"learning_rate": 1e-2, "momentum": 0.9,
                                   "nesterov": True}),
    "sgd-momentum-bf16": ("optax.sgd", {"learning_rate": 1e-2, "momentum": 0.9,
                                        "accumulator_dtype": "bfloat16"}),
}
# optax's state field -> the port's state key
STATE_KEYS = {"v": "v", "v_row": "v_row", "v_col": "v_col", "ema": "ema", "mu": "mu",
              "nu": "nu", "trace": "trace"}


def _optax(name: str, params: dict):
    kw = {k: (jnp.dtype(v) if k.endswith("dtype") or k == "dtype_momentum" else v)
          for k, v in params.items()}
    return getattr(optax, name.split(".")[1])(**kw)


def _draws(seed: int):
    """Flax-layout parameters and STEPS gradients (of three magnitudes)."""
    rng = np.random.RandomState(seed)
    p0 = {k: rng.randn(*shape).astype(np.float32) for k, (shape, _) in SHAPES.items()}
    grads = [{k: (rng.randn(*shape) * scale).astype(np.float32)
              for k, (shape, _) in SHAPES.items()}
             for scale in (1.0, 30.0, 1e-3, 3.0, 0.1)[:STEPS]]
    return p0, grads


def _to_torch(x, key: str) -> torch.Tensor:
    """A copy in torch's layout (never a view of the numpy draws, which a
    step would then change)."""
    return torch.tensor(np.transpose(np.asarray(x), SHAPES[key][1]))


def _run_optax(name, params, p0, grads):
    tx = _optax(name, params)
    p = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(p)
    update = jax.jit(tx.update)
    for g in grads:
        u, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, u)
    return p, state


def _make_torch(name, params, p0):
    tp = {k: torch.nn.Parameter(_to_torch(v, k)) for k, v in p0.items()}
    opt = toptim.optimizer_from_config({"name": name, "params": params})(list(tp.values()))
    return tp, opt


def _step(tp, opt, g):
    for k, p in tp.items():
        p.grad = _to_torch(g[k], k)
    opt.step()


def _state_in_torch_layout(field: str, want, key: str, p_torch: torch.Tensor):
    """optax's state tensor of ``key`` in the port's layout: the parameter's
    permutation, less the axis that a factored moment reduced."""
    want = np.asarray(want.astype(jnp.float32) if want.dtype == jnp.bfloat16 else want)
    perm = SHAPES[key][1]
    if field not in ("v_row", "v_col"):
        return np.transpose(want, perm)
    flax_shape = SHAPES[key][0]
    d1f, d0f = toptim._factored_dims(flax_shape)
    gone_f = d0f if field == "v_row" else d1f
    kept = [a for a in perm if a != gone_f]  # flax axes, in torch order
    return np.transpose(want, [a - (a > gone_f) for a in kept])


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax(case):
    """Five steps: each parameter and each state tensor against optax's."""
    name, params = CASES[case]
    p0, grads = _draws(31)
    want_p, want_state = _run_optax(name, params, p0, grads)
    tp, opt = _make_torch(name, params, p0)
    for g in grads:
        _step(tp, opt, g)
    checked = 0
    for k, p in tp.items():
        err = rel_l2(p.detach(), _to_torch(want_p[k], k))
        assert err <= TOL, f"{case} {k}: parameter rel_l2 {err:.3e}"
        for field, port_key in STATE_KEYS.items():
            if port_key not in opt.state[p]:
                continue
            got = opt.state[p][port_key]
            want = optax.tree_utils.tree_get(want_state, field)[k]
            assert got.dtype == {jnp.float32: torch.float32,
                                 jnp.bfloat16: torch.bfloat16}[want.dtype.type], field
            want = _state_in_torch_layout(field, want, k, p)
            assert tuple(got.shape) == want.shape, (case, k, field)
            if got.dtype == torch.bfloat16:  # one bf16 rounding apart at most
                err = rel_l2(got.float(), want)
                assert err <= 2.0 ** -8, f"{case} {k} {field}: rel_l2 {err:.3e}"
            else:
                err = rel_l2(got, want)
                assert err <= TOL, f"{case} {k} {field}: rel_l2 {err:.3e}"
            checked += 1
    stateful = not (name == "optax.sgd" and "momentum" not in params)
    assert checked >= len(SHAPES) * stateful


def _saved(state_dict) -> dict:
    buf = io.BytesIO()
    torch.save(state_dict, buf)
    buf.seek(0)
    return torch.load(buf, weights_only=True)


def _assert_same_state(a, b):
    for (ka, pa), (kb, pb) in zip(a[0].items(), b[0].items()):
        assert torch.equal(pa.detach(), pb.detach()), ka
        sa, sb = a[1].state[pa], b[1].state[pb]
        assert sa.keys() == sb.keys()
        for key, va in sa.items():
            vb = sb[key]
            if torch.is_tensor(va):
                assert va.dtype == vb.dtype and torch.equal(va, vb), (ka, key)
            else:
                assert va == vb, (ka, key)


@pytest.mark.parametrize("case", list(CASES))
def test_state_dict_resume_is_bitwise(case):
    """Two steps, a saved ``state_dict`` loaded into a fresh optimizer over
    copies of the parameters, three more steps: parameters and state equal
    bitwise to five steps straight, dtypes included."""
    name, params = CASES[case]
    p0, grads = _draws(32)
    straight = _make_torch(name, params, p0)
    for g in grads:
        _step(*straight, g)
    first = _make_torch(name, params, p0)
    for g in grads[:2]:
        _step(*first, g)
    saved = _saved(first[1].state_dict())
    resumed = _make_torch(name, params, {k: v for k, v in p0.items()})
    with torch.no_grad():
        for k, p in resumed[0].items():
            p.copy_(first[0][k])
    resumed[1].load_state_dict(saved)
    for g in grads[2:]:
        _step(*resumed, g)
    _assert_same_state(straight, resumed)


@pytest.mark.parametrize("case", ["adafactor-momentum-bf16", "adamw", "sgd-nesterov"])
def test_carriers_resume_bitwise(case):
    """``fp32_master_optimizer`` over bf16 parameters and a
    ``TensorTrainState`` carry the optimizer through a saved state: two steps,
    save, restore into fresh copies, two more, equal to four straight."""
    name, params = CASES[case]
    p0, grads = _draws(33)
    factory = fp32_master_optimizer(
        toptim.optimizer_from_config({"name": name, "params": params}))
    tensors = {k: _to_torch(v, k).bfloat16() for k, v in p0.items()}

    def run(state, gs):
        for g in gs:
            for k, p in state.params.items():
                p.grad = _to_torch(g[k], k).bfloat16()
            state.optimizer.step()
            state.step += 1

    straight = init_tensor_state(tensors, factory)
    run(straight, grads[:4])
    first = init_tensor_state(tensors, factory)
    run(first, grads[:2])
    resumed = init_tensor_state(tensors, factory)
    resumed.load_state_dict(_saved(first.state_dict()))
    run(resumed, grads[2:4])
    a, b = straight.state_dict(), resumed.state_dict()
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for m, n in zip(a["optimizer"]["masters"], b["optimizer"]["masters"]):
        assert torch.equal(m, n)
    for i, s in a["optimizer"]["state"].items():
        for key, v in s.items():
            w = b["optimizer"]["state"][i][key]
            assert (v.dtype == w.dtype and torch.equal(v, w)) if torch.is_tensor(v) \
                else v == w, (i, key)


@pytest.mark.parametrize("optim_params, error, words", [
    ({"name": "optax.lion", "params": {"learning_rate": 1e-4}}, NotImplementedError,
     ["optax.lion", "optax.adafactor", "optax.adam", "optax.adamw", "optax.sgd"]),
    ({"name": "optax.adamw", "params": {"learning_rate": 1e-4, "mask": {"w": True}}},
     NotImplementedError, ["mask"]),
    ({"name": "optax.adafactor", "params": {"weight_decay_rate": 1e-3,
                                            "weight_decay_mask": {"w": True}}},
     NotImplementedError, ["weight_decay_mask"]),
    ({"name": "optax.adam", "params": {"learning_rate": 1e-4, "weight_decay": 0.1}},
     TypeError, ["weight_decay"]),
    ({"name": "optax.sgd", "params": {}}, TypeError, ["learning_rate"]),
    ({"name": "optax.adam", "params": {"learning_rate": 1e-4, "mu_dtype": "float8"}},
     TypeError, ["float8"]),
])
def test_refusals(optim_params, error, words):
    """Refused by name before any optimizer is built; where the argument is
    one optax itself refuses, optax raises the same error."""
    with pytest.raises(error) as info:
        toptim.optimizer_from_config(optim_params)
    assert all(w in str(info.value) for w in words), str(info.value)
    if error is TypeError and "dtype" not in str(optim_params):
        with pytest.raises(TypeError):
            _optax(optim_params["name"], optim_params["params"])


def test_factored_axes_of_a_conv_kernel():
    """A 4-D conv kernel factors over its in and out channels in both
    layouts (OIHW here, HWIO in flax): the same pair of axes."""
    (flax_shape, perm) = SHAPES["conv"]
    torch_shape = tuple(flax_shape[a] for a in perm)
    d_torch = toptim._factored_dims(torch_shape)
    d_flax = toptim._factored_dims(flax_shape)
    assert [perm[a] for a in d_torch] == list(d_flax)
    assert {torch_shape[a] for a in d_torch} == {128, 144}


def test_decoder_step_with_adamw_matches_jax(jax_ref):
    """Two ``make_unclip_train_step`` steps on the tiny UNet with the YAML's
    freeze rules, ``optimizer_from_config(optax.adamw)`` and EMA, JAX's t and
    noise injected, against JAX's step with ``optax.adamw``: the losses at
    the module tolerance, the frozen tensors unchanged, and each trained
    tensor's update and its EMA's move within 1e-3 relative L2 of JAX's.
    ``test_torch_train.py`` holds the Adafactor step's largest element to
    1e-3 of the largest update; Adam divides each element by its own RMS,
    so an element whose gradient agrees to 1e-4 of its tensor's largest
    (the gradient test's bound) but is itself a hundredth of that largest
    steps up to 1 % apart: the middle block's qkv kernel has one 1.2 %
    apart, and 1.4e-4 in L2.  Where a tensor's gradient is rounding noise
    (below 1e-3 of the largest tensor's, as in the gradient test) the
    direction of Adam's step is noise too, and only its size is held: at
    most lr a step (|m̂| / √v̂ ≤ 1.0012 over two steps at optax's betas)."""
    lr = 1e-3
    params, mask = jax_ref["params"], jax_ref["mask"]
    mc = dict(jcfg.CONFIG_2_1["model_config"], **TINY_UNET)
    jm = jcfg.create_model(**mc, dtype=jnp.float32)
    jinit, jstep = jax_make_step(jm, DCFG, masked_optimizer(optax.adamw(lr), mask),
                                 ema_decay=0.9999)
    jstep = jax.jit(jstep)
    batches = [jax_ref["batch"], _tiny_batch(6)]
    jstate, jmetrics = jinit(params), []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.PRNGKey(0))
        jmetrics.append(m)

    tm = _torch_unet(params)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    init_state, train_step = ttrain.make_unclip_train_step(
        tm, DCFG, toptim.optimizer_from_config(
            {"name": "optax.adamw", "params": {"learning_rate": lr}}))
    state = init_state(toptim.decoder_freeze_mask(tm, freeze_resblocks=True))
    for i, b in enumerate(batches):
        t, noise = _jax_draws(0, i, (2, 16, 16, 4))
        metrics = train_step(state, _torch_batch(b), t=torch.tensor(t),
                             noise=torch.tensor(noise))
        for k in ("loss", "mse", "vb"):
            assert_close(metrics[k], jmetrics[i][k], MODULE_TOL, f"step {i} {k}")
    assert state.step == 2 and int(jstate.step) == 2
    assert isinstance(state.optimizer, toptim.Adam)
    assert state.optimizer.param_groups[0]["weight_decay"] == 1e-4
    new = jax_to_state_dict(jstate.params, tm)
    ema = jax_to_state_dict(jstate.ema_params, tm)
    grads = jax_to_state_dict(jax_ref["grads"], tm)
    top = max(float(g.abs().max()) for g in grads.values())
    trainable = {torch_key_for(p): bool(v) for p, v in flatten(mask).items()}
    for name, p in tm.named_parameters():
        if not trainable[name]:
            assert torch.equal(p.detach(), before[name]), name
            continue
        if float(grads[name].abs().max()) < 1e-3 * top:
            step = float((p.detach() - before[name]).abs().max())
            assert step <= 2.01 * lr, f"{name}: a step of {step:.3e}"
        else:
            for what, got, want in (("update", p.detach(), new[name]),
                                    ("EMA's move", state.ema_params[name], ema[name])):
                err = rel_l2(got - before[name], want - before[name])
                assert err <= 1e-3, f"{name} {what}: rel_l2 {err:.3e}"


def test_chip_smoke_runs_the_same_option_sets():
    """``chip_smoke.py`` phase 19a runs these option sets on the card."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.OPTIM_CASES == CASES
    assert mod.ADAMW == {"name": "optax.adamw", "params": {"learning_rate": 1e-4}}
