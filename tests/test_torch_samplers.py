"""The port's samplers (``kandinsky2_tpu_torch/diffusion/samplers.py``) and
the dynamic threshold against the JAX package's, in fp32 on the CPU: every
table function at 1e-6, and every loop on one toy model (the same affine
map of x and t in both frameworks) with the noise injected, at 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kandinsky2_tpu import diffusion as jd
from kandinsky2_tpu.diffusion import samplers as js
from kandinsky2_tpu_torch import diffusion as td
from test_torch_common import assert_close

T = torch.from_numpy
TABLE_TOL = 1e-6
LOOP_TOL = 1e-5
# the 2.1 decoder's and prior's schedules (configs.py: CONFIG_2_1)
DECODER = dict(steps=1000, noise_schedule="linear", linear_start=0.00085,
               linear_end=0.012, rescale_timesteps=True)
PRIOR = dict(steps=1000, noise_schedule="cosine")
# the 2.0 decoder's (CONFIG_2_0): linear 1e-4 to 2e-2
DECODER20 = dict(steps=1000, noise_schedule="linear", linear_start=0.0001,
                 linear_end=0.02, rescale_timesteps=True)


def _base():
    """The decoder's base alphas_cumprod, as both pipelines build it."""
    return np.asarray(jd.make_schedule(**DECODER).alphas_cumprod, np.float64)


TABLES = {
    "ddim": lambda m, base: m.make_ddim_tables(base, 50),
    "ddim eta 0.5": lambda m, base: m.make_ddim_tables(base, 25, eta=0.5),
    "ddim init_step": lambda m, base: m.make_ddim_tables(base, 50, init_step=300),
    "dpmpp": lambda m, base: m.make_dpmpp_tables(base, 20),
    "dpmpp init_step": lambda m, base: m.make_dpmpp_tables(base, 20, init_step=650),
    "dpmpp ladder": lambda m, base: m.make_dpmpp_tables(
        base, ladder=np.arange(999, -1, -111)),
    "karras": lambda m, base: m.make_dpmpp_karras_tables(base, 15),
    "karras init_step": lambda m, base: m.make_dpmpp_karras_tables(
        base, 15, init_step=500),
    "dpmpp respaced prior 25": lambda m, base: m.make_dpmpp_tables_from_respaced(
        m.make_schedule(**PRIOR, timestep_respacing="25")),
    "dpmpp respaced decoder 10": lambda m, base: m.make_dpmpp_tables_from_respaced(
        m.make_schedule(**DECODER, timestep_respacing="10")),
}


class _Jax:
    """The JAX samplers module with ``make_schedule`` beside it, as the
    port's ``diffusion`` package holds both."""

    def __getattr__(self, name):
        return getattr(jd if name == "make_schedule" else js, name)


@pytest.mark.parametrize("case", list(TABLES))
def test_tables_match_jax(case):
    base = _base()
    want = TABLES[case](_Jax(), base)
    got = TABLES[case](td, base)
    assert type(got).__name__ == type(want).__name__
    for name in want._fields:
        w = np.asarray(getattr(want, name), np.float64)
        g = getattr(got, name)
        g = np.asarray(g.numpy() if isinstance(g, torch.Tensor) else g, np.float64)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        err = np.abs(g - w).max() / max(1.0, np.abs(w).max())
        assert err <= TABLE_TOL, f"{case} {name}: {err:.3e}"


# --- loops ------------------------------------------------------------------

SHAPE = (2, 4, 4, 3)  # NHWC latents, batch 2


def _weights(seed, c_out):
    return np.random.RandomState(seed).randn(SHAPE[-1], c_out).astype(np.float32) / 3


def _jtoy(w):
    w = jnp.asarray(w)
    return lambda x, t: (x @ w) * 0.3 + 0.001 * t[:, None, None, None]


def _ttoy(w):
    w = T(w)
    return lambda x, t: (x @ w) * 0.3 + 0.001 * t[:, None, None, None]


def _jstate(w):
    """A stateful toy: the output carries the state, refreshed to the mean
    of x on even positions."""
    f = _jtoy(w)

    def fn(x, t, state, pos):
        state = jnp.where(pos % 2 == 0, x.mean(), state)
        return f(x, t) + 0.05 * state, state

    return fn


def _tstate(w):
    f = _ttoy(w)

    def fn(x, t, state, pos):
        if pos % 2 == 0:
            state = x.mean()
        return f(x, t) + 0.05 * state, state

    return fn


def _noise(seed, n):
    return np.random.RandomState(seed).randn(n, *SHAPE).astype(np.float32)


def _x_T(seed=0):
    return np.random.RandomState(100 + seed).randn(*SHAPE).astype(np.float32)


def case_p_sample():
    """EPSILON with LEARNED_RANGE on NHWC, dynamic threshold, the ±2
    denoised_fn and init_step, over the decoder's schedule respaced to 10."""
    w, nseq, x_T = _weights(1, 6), _noise(2, 6), _x_T()

    def run(m, toy, tensor, clip):
        return m.p_sample_loop(
            toy(w), m.make_schedule(**DECODER, timestep_respacing="10"), tensor(x_T),
            mean_type=m.MeanType.EPSILON, var_type=m.VarType.LEARNED_RANGE,
            clip_denoised=True, denoised_fn=clip, init_step=6,
            noise_seq=tensor(nseq), channel_axis=-1)

    return (run(jd, _jtoy, jnp.asarray, lambda v: jnp.clip(v, -2, 2)),
            run(td, _ttoy, T, lambda v: torch.clamp(v, -2, 2)))


def case_p_sample_stateful():
    w, nseq, x_T = _weights(3, 6), _noise(4, 10), _x_T(1)

    def run(m, toy, tensor, state):
        return m.p_sample_loop(
            toy(w), m.make_schedule(**DECODER, timestep_respacing="10"), tensor(x_T),
            mean_type=m.MeanType.EPSILON, var_type=m.VarType.LEARNED_RANGE,
            clip_denoised=True, channel_axis=-1, noise_seq=tensor(nseq),
            model_state=state)

    return (run(jd, _jstate, jnp.asarray, jnp.zeros(())),
            run(td, _tstate, T, torch.zeros(())))


def _ddim(eta=0.0, init_step=None, nseq=None, stateful=False, loop="ddim_loop"):
    w, x_T = _weights(5, 3), _x_T(2)
    base = _base()

    def run(m, toy, tensor, state):
        tables = m.make_ddim_tables(base, 25, eta=eta, init_step=init_step)
        kw = dict(model_state=state)
        if loop == "ddim_loop":
            kw.update(eta=eta, noise_seq=None if nseq is None else tensor(nseq))
        return getattr(m, loop)(toy(w), tables, tensor(x_T), **kw)

    if stateful:
        return (run(js, _jstate, jnp.asarray, jnp.zeros(())),
                run(td, _tstate, T, torch.zeros(())))
    return run(js, _jtoy, jnp.asarray, None), run(td, _ttoy, T, None)


def _dpmpp(make, stateful=False, **kw):
    w, x_T = _weights(6, 3), _x_T(3)
    base = _base()

    def run(m, toy, state):
        tables = getattr(m, make)(base, 12, **kw)
        tensor = jnp.asarray if m is js else T
        return m.dpmpp_2m_loop(toy(w), tables, tensor(x_T), model_state=state)

    if stateful:
        return run(js, _jstate, jnp.zeros(())), run(td, _tstate, torch.zeros(()))
    return run(js, _jtoy, None), run(td, _ttoy, None)


def case_ddim_respaced(eta):
    """The prior's "ddim…" ladder: START_X, FIXED_SMALL, the ±10 clamp."""
    w, x_T = _weights(7, 3), _x_T(4)
    nseq = _noise(8, 5)

    def run(m, toy, tensor, clamp):
        return m.ddim_respaced_loop(
            toy(w), m.make_schedule(**PRIOR, timestep_respacing="ddim5"), tensor(x_T),
            mean_type=m.MeanType.START_X, var_type=m.VarType.FIXED_SMALL,
            clip_denoised=False, denoised_fn=clamp, eta=eta, noise_seq=tensor(nseq),
            channel_axis=-1)

    return (run(jd, _jtoy, jnp.asarray, lambda v: jnp.clip(v, -10, 10)),
            run(td, _ttoy, T, lambda v: torch.clamp(v, -10, 10)))


def case_dpmpp_respaced_xstart():
    """The prior's "dpmpp…" ladder: x0 predictions, the ±10 clamp."""
    w, x_T = _weights(9, 3), _x_T(5)

    def run(m, toy, tensor, clamp):
        sched = m.make_schedule(**PRIOR, timestep_respacing="10")
        tables = (js if m is jd else m).make_dpmpp_tables_from_respaced(sched)
        return m.dpmpp_2m_loop(toy(w), tables, tensor(x_T), prediction="xstart",
                               denoised_fn=clamp)

    return (run(jd, _jtoy, jnp.asarray, lambda v: jnp.clip(v, -10, 10)),
            run(td, _ttoy, T, lambda v: torch.clamp(v, -10, 10)))


def case_ddim20_img2img():
    """2.0's img2img default: stochastic DDIM (eta 0.05) over its own base
    schedule, the ladder truncated at t <= 300, the noise injected."""
    w, x_T = _weights(11, 3), _x_T(6)
    base = np.asarray(jd.make_schedule(**DECODER20).alphas_cumprod, np.float64)
    nseq = _noise(12, len(td.schedules.ddim_ladder(25, init_step=300)))

    def run(m, toy, tensor):
        tables = m.make_ddim_tables(base, 25, eta=0.05, init_step=300)
        return m.ddim_loop(toy(w), tables, tensor(x_T), eta=0.05,
                           noise_seq=tensor(nseq))

    return run(js, _jtoy, jnp.asarray), run(td, _ttoy, T)


def case_p_sample20_inpaint():
    """2.0's inpainting p_sampler: over its schedule respaced to 10, from
    respaced step 7, x0 dynamic-thresholded at 99.5 and blended with the
    known latent by the mask, then the loop's own dynamic threshold."""
    w, nseq, x_T = _weights(13, 6), _noise(14, 7), _x_T(7)
    rng = np.random.RandomState(15)
    known = rng.randn(*SHAPE).astype(np.float32)
    mask = (rng.rand(*SHAPE[:-1], 1) > 0.5).astype(np.float32)

    def run(m, toy, tensor, threshold):
        k, mk = tensor(known), tensor(mask)
        return m.p_sample_loop(
            toy(w), m.make_schedule(**DECODER20, timestep_respacing="10"), tensor(x_T),
            mean_type=m.MeanType.EPSILON, var_type=m.VarType.LEARNED_RANGE,
            clip_denoised=True, init_step=7, noise_seq=tensor(nseq), channel_axis=-1,
            denoised_fn=lambda x0: threshold(x0, 99.5) * (1 - mk) + k * mk)

    return (run(jd, _jtoy, jnp.asarray, jd.dynamic_threshold),
            run(td, _ttoy, T, td.dynamic_threshold))


LOOPS = {
    "p_sample_loop epsilon learned_range clip init_step": case_p_sample,
    "p_sample_loop stateful": case_p_sample_stateful,
    "ddim": lambda: _ddim(),
    "ddim eta 0.5 noise_seq": lambda: _ddim(eta=0.5, nseq=_noise(10, 25)),
    "ddim init_step": lambda: _ddim(init_step=400),
    "ddim stateful": lambda: _ddim(stateful=True),
    "plms": lambda: _ddim(loop="plms_loop"),
    "plms init_step": lambda: _ddim(init_step=600, loop="plms_loop"),
    "plms stateful": lambda: _ddim(stateful=True, loop="plms_loop"),
    "dpmpp 2m": lambda: _dpmpp("make_dpmpp_tables"),
    "dpmpp 2m stateful": lambda: _dpmpp("make_dpmpp_tables", stateful=True),
    "dpmpp karras": lambda: _dpmpp("make_dpmpp_karras_tables"),
    "dpmpp karras init_step": lambda: _dpmpp("make_dpmpp_karras_tables",
                                             init_step=700),
    "ddim_respaced_loop": lambda: case_ddim_respaced(0.0),
    "ddim_respaced_loop eta 1": lambda: case_ddim_respaced(1.0),
    "dpmpp respaced xstart": case_dpmpp_respaced_xstart,
    "ddim 2.0 eta 0.05 init_step noise_seq": case_ddim20_img2img,
    "p_sample_loop 2.0 inpainting threshold and blend": case_p_sample20_inpaint,
}


@pytest.mark.parametrize("case", list(LOOPS))
def test_loops_match_jax(case):
    want, got = LOOPS[case]()
    assert_close(got, want, LOOP_TOL, case)
    assert np.std(np.asarray(want)) > 1e-3, "the toy trajectory collapsed"


@pytest.mark.parametrize("scale", [0.5, 3.0, 40.0])
def test_dynamic_threshold_matches_jax(scale):
    """The 99.5th percentile of |x[0]| (linear interpolation), at least 1,
    clips and rescales the batch; both sides of the floor of 1."""
    x = (scale * np.random.RandomState(11).randn(2, 24, 24, 4)).astype(np.float32)
    want = jd.dynamic_threshold(jnp.asarray(x))
    got = td.dynamic_threshold(T(x))
    assert_close(got, want, LOOP_TOL, "dynamic_threshold")
    if scale > 1:
        assert float(np.abs(np.asarray(want)).max()) == pytest.approx(1.0)


def test_predict_helpers_match_jax():
    sched_kw = dict(DECODER, timestep_respacing="20")
    js_, ts_ = jd.make_schedule(**sched_kw), td.make_schedule(**sched_kw)
    rng = np.random.RandomState(12)
    x, y = (rng.randn(*SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([3, 19])
    from kandinsky2_tpu.diffusion import gaussian as jg

    for name in ("predict_xstart_from_xprev", "predict_eps_from_xstart",
                 "predict_xstart_from_eps"):
        want = getattr(jg, name)(js_, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
        got = getattr(td, name)(ts_, T(x), T(t), T(y))
        assert_close(got, want, LOOP_TOL, name)
