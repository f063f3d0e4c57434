"""The port's 2.0 text side against the JAX package's, in fp32 on the CPU,
every parameter drawn from a numpy seed and loaded into both through the
bridge: T5's relative-position buckets (integer equality), ``RMSNorm``,
``T5Encoder``, ``AttentionPooling`` and every backend of the
``TextEncoder`` facade, at 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kandinsky2_tpu.models import layers as jlayers
from kandinsky2_tpu.models import t5 as jt5
from kandinsky2_tpu.models import text_encoders as jte
from kandinsky2_tpu_torch.models import layers as tlayers
from kandinsky2_tpu_torch.models import t5 as tt5
from kandinsky2_tpu_torch.models import text_encoders as tte
from kandinsky2_tpu_torch.weights.from_jax import load_jax_params
from test_torch_common import MODULE_TOL, assert_close, numpy_params

T = torch.from_numpy


@pytest.mark.parametrize("buckets,max_distance,T_", [(32, 128, 77), (8, 20, 77),
                                                      (32, 128, 512)])
def test_relative_position_bucket_equals_jax(buckets, max_distance, T_):
    """Every relative distance of a T-token sequence (−76..76 for the
    pipeline's 77), the full config's table and the tiny one's."""
    rel = np.arange(-(T_ - 1), T_, dtype=np.int32)
    want = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), buckets,
                                                   max_distance))
    got = tt5.relative_position_bucket(T(rel).long(), buckets, max_distance).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < buckets


def _ids(seed, B=2, L=11, vocab=120):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    ids[1, 7:], mask[1, 7:] = 1, 0  # a padded row
    return ids, mask


def _pair(jm, tm, args, seed):
    """JAX's output on numpy-seeded parameters, which are loaded into
    ``tm``."""
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args), seed)
    want = jax.jit(lambda p, *a: jm.apply(p, *a))(params, *args)
    load_jax_params(tm, params["params"])
    return want


def test_rmsnorm():
    x = np.random.RandomState(1).randn(2, 5, 16).astype(np.float32) * 3
    tm = tt5.RMSNorm(16)
    want = _pair(jt5.RMSNorm(), tm, (x,), 1)
    assert_close(tm(T(x)), want, MODULE_TOL, "RMSNorm")


T5_SMALL = dict(vocab_size=120, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                num_heads=4, rel_buckets=8, rel_max_distance=20)


def test_t5_encoder():
    ids, mask = _ids(2)
    jm, tm = jt5.T5Encoder(**T5_SMALL), tt5.T5Encoder(**T5_SMALL)
    want = _pair(jm, tm, (ids, mask), 2)
    with torch.no_grad():
        got = tm(T(ids).long(), T(mask))
    assert_close(got, want, MODULE_TOL, "T5Encoder")


@pytest.mark.parametrize("x_dim", [None, 24])
def test_attention_pooling(x_dim):
    """Unmasked 8-head pooling: over padded positions too, as the
    reference; position 0 of the projected output."""
    x = np.random.RandomState(3).randn(2, 9, x_dim or 32).astype(np.float32)
    jm = jlayers.AttentionPooling(8, 32, 48)
    tm = tlayers.AttentionPooling(8, 32, 48, x_dim=x_dim)
    want = _pair(jm, tm, (x,), 3)
    with torch.no_grad():
        got = tm(T(x))
    assert got.shape == (2, 48)
    assert_close(got, want, MODULE_TOL, "AttentionPooling")


# backend: the facade's kwargs
BACKENDS = {
    "multiclip": dict(in_features=32, out_features=24, layers=2, heads=4,
                      intermediate=64, vocab_size=120, max_positions=40),
    "clip": dict(in_features=32, out_features=24, layers=2, heads=4,
                 vocab_size=120, max_positions=11),
    "T5EncoderModel": dict(in_features=32, layers=2, heads=4, intermediate=64,
                           vocab_size=120),
    "MT5EncoderModel": dict(in_features=32, layers=2, heads=4, intermediate=64,
                            vocab_size=120),
    "BertModel": dict(in_features=32, layers=2, heads=4, intermediate=64,
                      vocab_size=120, max_positions=40),
    "xlm_roberta": dict(in_features=32, layers=2, heads=4, intermediate=64,
                        vocab_size=120, max_positions=40),
}


@pytest.mark.parametrize("name", list(BACKENDS))
def test_text_encoder_backends(name):
    """Each backend's (full, pooled), pooled None where it has none."""
    ids, mask = _ids(4)
    kw = BACKENDS[name]
    jm = jte.TextEncoder(model_name=name, **kw)
    tm = tte.TextEncoder(model_name=name, **kw)
    want = _pair(jm, tm, (ids, mask), 4)
    with torch.no_grad():
        got = tm(T(ids).long(), T(mask))
    assert len(got) == len(want) == 2
    assert (got[1] is None) == (want[1] is None)
    for k, (g, w) in enumerate(zip(got, want)):
        if w is not None:
            assert_close(g, w, MODULE_TOL, f"TextEncoder({name})[{k}]")


def test_unknown_backend_raises():
    with pytest.raises(NotImplementedError):
        tte.TextEncoder(model_name="gpt2", device="meta")
