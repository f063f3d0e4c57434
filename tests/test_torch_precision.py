"""The port's mixed-precision helpers (``kandinsky2_tpu_torch/train/
precision.py``) against the JAX package's ``train/precision.py``: which
tensors ``cast_torso`` keeps fp32 on a whole UNet's parameters (through the
weight bridge's names), and the fp32-master optimizer's small updates that
bf16 alone would lose (``tests/test_precision.py``'s case)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from kandinsky2_tpu import configs as jcfg
from kandinsky2_tpu.train import precision as jprec
from kandinsky2_tpu_torch import configs as tcfg
from kandinsky2_tpu_torch.train import precision as tprec
from kandinsky2_tpu_torch.weights.from_jax import flatten, load_jax_params, torch_key_for
from test_torch_common import TINY_UNET, numpy_params


def _unet_pair():
    mc = dict(jcfg.CONFIG_2_1["model_config"], **TINY_UNET)
    jm = jcfg.create_model(**mc, dtype=jnp.float32)
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        full_emb=jnp.zeros((1, 3, 16)), pooled_emb=jnp.zeros((1, 32)),
        image_emb=jnp.zeros((1, 32)))
    params = numpy_params(shapes["params"], 1)
    tm = load_jax_params(tcfg.create_model(**mc, dtype=torch.float32), params)
    return params, tm


def test_cast_torso_keeps_what_jax_keeps_fp32():
    """Every tensor of the tiny 2.1 UNet, as a state dict and as a module:
    the port's dtype after ``cast_torso(bf16)`` is the JAX leaf's after its
    ``cast_torso``, through ``torch_key_for`` (norm scales and every bias
    fp32, kernels bf16); ``cast_params`` casts all of them."""
    params, tm = _unet_pair()
    want = {torch_key_for(p): str(v.dtype) for p, v in
            flatten(jprec.cast_torso(params, jnp.bfloat16)).items()}
    assert "float32" in want.values() and "bfloat16" in want.values()
    as_dict = tprec.cast_torso(dict(tm.named_parameters()), torch.bfloat16)
    tprec.cast_torso(tm, torch.bfloat16)
    for got in (as_dict, dict(tm.named_parameters())):
        assert {k: str(v.dtype).replace("torch.", "") for k, v in got.items()} == want
    every = tprec.cast_params(dict(tm.named_parameters()), torch.bfloat16)
    assert {v.dtype for v in every.values()} == {torch.bfloat16}


def test_cast_torso_leaves_integers_alone():
    params = {"conv.weight": torch.ones(4, 4, 3, 3), "conv.bias": torch.ones(4),
              "norm.weight": torch.ones(4), "step": torch.zeros((), dtype=torch.int32)}
    out = tprec.cast_torso(params, torch.bfloat16)
    assert out["conv.weight"].dtype == torch.bfloat16
    assert out["conv.bias"].dtype == out["norm.weight"].dtype == torch.float32
    assert out["step"].dtype == torch.int32


def test_fp32_master_optimizer_accumulates_small_updates():
    """bf16 cannot hold 1 − k·1e-3 steps; the masters must.  Eight SGD
    steps at lr 1e-3 on bf16 parameters with gradient 1: the masters equal
    ``optax``'s through ``fp32_master_optimizer`` (1e-6), the live
    parameters equal its bf16 ones exactly, every step."""
    tx = jprec.fp32_master_optimizer(optax.sgd(1e-3))
    jp = {"w": jnp.ones((4,), jnp.bfloat16)}
    jstate = tx.init(jp)
    g = {"w": jnp.ones((4,), jnp.bfloat16)}
    live = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    opt = tprec.fp32_master_optimizer(lambda ps: torch.optim.SGD(ps, lr=1e-3))([live])
    for _ in range(8):
        updates, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        live.grad = torch.ones(4, dtype=torch.bfloat16)
        opt.step()
        opt.zero_grad()
        assert live.grad is None and live.dtype == torch.bfloat16
        np.testing.assert_allclose(opt.masters[0].detach().numpy(),
                                   np.asarray(jstate[0]["w"]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(live.detach().float().numpy(),
                                      np.asarray(jp["w"], np.float32))
    np.testing.assert_allclose(opt.masters[0].detach().numpy(), 1.0 - 8e-3, atol=1e-5)
    assert float(live.detach()[0]) < 1.0


def test_fp32_master_state_round_trips():
    """``state_dict`` carries the masters and the inner optimizer's state: a
    fresh wrapper loaded from it steps exactly as the original does."""
    def make():
        p = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
        return p, tprec.fp32_master_optimizer(
            lambda ps: torch.optim.Adam(ps, lr=1e-3))([p])

    a, opt_a = make()
    for _ in range(3):
        a.grad = torch.full((3,), 0.5, dtype=torch.bfloat16)
        opt_a.step()
    b, opt_b = make()
    opt_b.load_state_dict(copy.deepcopy(opt_a.state_dict()))
    with torch.no_grad():
        b.copy_(a)
    for p, opt in ((a, opt_a), (b, opt_b)):
        p.grad = torch.full((3,), -0.25, dtype=torch.bfloat16)
        opt.step()
    assert torch.equal(a, b) and torch.equal(opt_a.masters[0], opt_b.masters[0])


def test_cast_torso_custom_keep_fp32_matches_jax():
    """A custom ``keep_fp32`` predicate (on the tensor's name) keeps the
    same tensors fp32 as JAX's ``cast_torso`` with the same predicate."""
    params, tm = _unet_pair()
    keep = lambda name: "out_layers" in name or "time_embed" in name
    want = {torch_key_for(p): str(v.dtype) for p, v in
            flatten(jprec.cast_torso(params, jnp.bfloat16, keep)).items()}
    kept = {k for k, v in want.items() if v == "float32"}
    assert kept and all("out_layers" in k or "time_embed" in k for k in kept)
    assert any(k.endswith("bias") for k, v in want.items() if v == "bfloat16")
    as_dict = tprec.cast_torso(dict(tm.named_parameters()), torch.bfloat16, keep)
    tprec.cast_torso(tm, torch.bfloat16, keep)
    for got in (as_dict, dict(tm.named_parameters())):
        assert {k: str(v.dtype).replace("torch.", "") for k, v in got.items()} == want
