"""Shared helpers for the parity tests of the PyTorch port against the JAX
package: the ``bench.py --small`` configuration (the port's
``small_config``, which both packages read), parameters drawn from a numpy
seed (every leaf non-zero, including the leaves flax initialises to zero),
and conversions between the two frameworks."""

import math

import jax
import numpy as np
import pytest
import torch

from kandinsky2_tpu import configs as jax_configs
from kandinsky2_tpu_torch import configs as torch_configs
from kandinsky2_tpu_torch.configs import small_config  # noqa: F401  (re-exported)

MODULE_TOL = 1e-4  # per module, fp32 (PARITY.md)
E2E_TOL = 3e-3  # seeded end-to-end image, fp32 (PARITY.md)


def numpy_params(jax_tree, seed: int):
    """A tree of the same structure as ``jax_tree`` (arrays or the shapes
    from ``jax.eval_shape``) with every leaf drawn from a numpy seed:
    kernels ~ N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), everything else
    ~ N(0, 0.1²) (projection matrices N(0, 1/rows))."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        shape = tuple(leaf.shape)
        z = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return z / math.sqrt(max(1, int(np.prod(shape[:-1]))))
        if name == "scale":
            return 1.0 + 0.1 * z
        if name in ("text_projection", "proj"):
            return z / math.sqrt(shape[0])
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(draw, jax_tree)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol, what=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol * scale:.3e}"


def test_config_copy_matches_jax_package():
    """The tests hand the port's config to both packages, so its copy of
    ``CONFIG_2_1`` must be the JAX package's."""
    assert torch_configs.CONFIG_2_1 == jax_configs.CONFIG_2_1


@pytest.mark.parametrize("name,args", [
    ("parse_channel_mult", ("", 64)), ("parse_channel_mult", ("1,2", 64)),
    ("parse_attention_ds", ("32,16,8", 64)),
])
def test_config_helpers_match_jax_package(name, args):
    assert getattr(torch_configs, name)(*args) == getattr(jax_configs, name)(*args)


def test_small_config_head_width():
    assert small_config()["model_config"]["num_head_channels"] == 32
    cfg = small_config(head_channels=64)
    assert cfg["model_config"]["num_head_channels"] == 64
    assert cfg["image_enc_params"]["params"]["n_embed"] == 64
    assert torch_configs.CONFIG_2_1["model_config"]["num_head_channels"] == 64


def test_numpy_params_fill_every_leaf():
    tree = {"a": {"kernel": np.zeros((3, 4)), "bias": np.zeros(4)},
            "n": {"scale": np.ones(4)}}
    out = numpy_params(tree, 0)
    for leaf in jax.tree_util.tree_leaves(out):
        assert np.all(leaf != 0)
