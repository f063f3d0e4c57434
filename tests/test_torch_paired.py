"""The port's paired-timestep ancestral scheduler (the 2.2 family,
``kandinsky2_tpu_torch/diffusion/paired.py``) against the JAX package's on
the CPU: the ladders equal exactly, and the loop for each prediction,
variance and clip, and with the stateful model contract, at the
sampler-loop tolerance with the per-step noise injected."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kandinsky2_tpu.diffusion import paired as jpaired
from kandinsky2_tpu.diffusion.schedules import named_betas
from kandinsky2_tpu_torch.diffusion import paired as tpaired
from test_torch_common import assert_close

LOOP_TOL = 1e-5  # per sampler loop, fp32 (PARITY.md)
ACP = {
    "linear": np.cumprod(1.0 - named_betas("linear", 1000, 0.00085, 0.012)),
    "cosine": np.cumprod(1.0 - named_betas("cosine", 1000)),
}


@pytest.mark.parametrize("steps,train", [(25, 1000), (50, 1000), (7, 1000), (5, 100),
                                         (1, 1000), (1000, 1000)])
def test_ladders_equal_jax(steps, train):
    for name in ("ddpm_ladder", "unclip_ladder"):
        want = getattr(jpaired, name)(steps, train)
        got = getattr(tpaired, name)(steps, train)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


def _models(channels_out):
    """The same toy model in both frameworks: a t-dependent map of x, with
    variance channels in [-1, 1] where the loop wants them."""

    def jmodel(x, t):
        y = jnp.tanh(x) * 0.8 + 1e-4 * t[:, None, None, None]
        if channels_out == 2:
            return jnp.concatenate([y, jnp.sin(x)], axis=-1)
        return y

    def tmodel(x, t):
        y = torch.tanh(x) * 0.8 + 1e-4 * t[:, None, None, None]
        if channels_out == 2:
            return torch.cat([y, torch.sin(x)], dim=-1)
        return y

    return jmodel, tmodel


@pytest.mark.parametrize("prediction,variance,clip,schedule", [
    ("epsilon", "learned_range", 2.0, "linear"),   # the 2.2 decoder
    ("sample", "fixed_small_log", 10.0, "cosine"),  # the 2.2 prior
    ("epsilon", "fixed_small", None, "linear"),
    ("sample", "learned_range", None, "cosine"),
    ("epsilon", "fixed_small_log", 1.0, "cosine"),
])
def test_paired_loop_matches_jax(prediction, variance, clip, schedule):
    ladder = jpaired.ddpm_ladder(6)
    rng = np.random.RandomState(2)
    x_T = rng.randn(2, 4, 4, 3).astype(np.float32)
    noise_seq = rng.randn(6, 2, 4, 4, 3).astype(np.float32)
    jmodel, tmodel = _models(2 if variance == "learned_range" else 1)
    acp = ACP[schedule]
    kw = dict(prediction=prediction, variance=variance, clip_range=clip)
    want = jpaired.paired_ancestral_loop(
        jmodel, jnp.asarray(acp, jnp.float32), ladder, jnp.asarray(x_T),
        noise_seq=jnp.asarray(noise_seq), **kw)
    got = tpaired.paired_ancestral_loop(
        tmodel, acp, ladder, torch.from_numpy(x_T),
        noise_seq=torch.from_numpy(noise_seq), **kw)
    assert got.dtype == torch.float32
    assert_close(got, want, LOOP_TOL, f"{prediction}/{variance}/{clip}")


def test_paired_loop_stateful_contract_matches_jax():
    """``model_fn(x, t, state, pos) -> (out, state)``: the state carried from
    step to step (a running sum refreshed every second step), on a truncated
    ladder."""
    ladder = jpaired.ddpm_ladder(8)[3:]
    rng = np.random.RandomState(3)
    x_T = rng.randn(1, 4, 4, 4).astype(np.float32)
    noise_seq = rng.randn(len(ladder), 1, 4, 4, 4).astype(np.float32)

    def jmodel(x, t, state, pos):
        state = jnp.where(pos % 2 == 0, 0.5 * x, state + 0.1 * x)
        return jnp.concatenate([0.3 * x + state, jnp.cos(x)], -1), state

    seen = []

    def tmodel(x, t, state, pos):
        seen.append(pos)
        state = 0.5 * x if pos % 2 == 0 else state + 0.1 * x
        return torch.cat([0.3 * x + state, torch.cos(x)], -1), state

    acp = ACP["linear"]
    want = jpaired.paired_ancestral_loop(
        jmodel, jnp.asarray(acp, jnp.float32), ladder, jnp.asarray(x_T),
        noise_seq=jnp.asarray(noise_seq), model_state=jnp.zeros((1, 4, 4, 4)))
    got = tpaired.paired_ancestral_loop(
        tmodel, acp, ladder, torch.from_numpy(x_T),
        noise_seq=torch.from_numpy(noise_seq), model_state=torch.zeros(1, 4, 4, 4))
    assert seen == list(range(len(ladder)))
    assert_close(got, want, LOOP_TOL, "stateful")


def test_generator_draws_are_seeded_and_last_step_adds_none():
    """Without ``noise_seq`` the per-step noise comes from the generator:
    the same seed gives the same walk; a one-step ladder is deterministic
    (its only step is the last)."""
    model = lambda x, t: torch.cat([0.2 * x, torch.zeros_like(x)], -1)
    x_T = torch.randn(1, 4, 4, 4, generator=torch.Generator().manual_seed(0))
    run = lambda seed, steps: tpaired.paired_ancestral_loop(
        model, ACP["linear"], tpaired.ddpm_ladder(steps), x_T,
        torch.Generator().manual_seed(seed))
    assert torch.equal(run(1, 5), run(1, 5))
    assert not torch.equal(run(1, 5), run(2, 5))
    assert torch.equal(run(1, 1), run(2, 1))
