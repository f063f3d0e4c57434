"""``weights.realistic.torch_init_stats`` against the JAX package's: on the
tiny 2.1 and 2.2 pipelines it resamples the same set of tensors (the
JAX ``kernel`` and ``embedding`` leaves, by the bridge's name map), keeps
the same all-zero tensor at zero and leaves every other tensor as it was;
the draws have the torch-default statistics (|w| ≤ 1/√fan_in with a
standard deviation near 1/√(3·fan_in); embeddings N(0, 1))."""

import copy

import jax
import numpy as np
import pytest
import torch

from kandinsky2_tpu.weights.realistic import torch_init_stats as jax_init_stats
from kandinsky2_tpu_torch.weights.from_jax import flatten, torch_key_for
from kandinsky2_tpu_torch.weights.realistic import torch_init_stats
from test_torch_common import shared_pair

# the output conv each test zeroes first (the reference's zero_module)
ZEROED = {"2.1": ("unet", "out.2"), "2.2": ("unet", "conv_out")}


@pytest.mark.parametrize("version", ["2.1", "2.2"])
def test_same_tensors_resampled_as_jax(version):
    _, tp, params = shared_pair(version)
    params = copy.deepcopy(params)
    model, layer = ZEROED[version]
    params[model][layer]["kernel"] = np.zeros_like(params[model][layer]["kernel"])
    # JAX's rule picks by leaf name, rank and zeros, never by size: run it
    # on 2-wide stand-ins of every leaf (its eager draws compile once a shape)
    proxy = jax.tree_util.tree_map(
        lambda a: np.full((2,) * np.ndim(a), 0.0 if not np.any(a) else 0.5,
                          np.float32), params)
    new = jax_init_stats(proxy, jax.random.PRNGKey(0))
    pipe = copy.deepcopy(tp)
    pipe.load_jax_params(params)
    gen = torch.Generator().manual_seed(0)
    for name, module in pipe.models().items():
        before = {k: v.clone() for k, v in module.state_dict().items()}
        assert torch_init_stats(module, gen) is module
        after = module.state_dict()
        old_flat, new_flat = flatten(proxy[name]), flatten(new[name])
        jax_changed = {torch_key_for(p) for p in old_flat
                       if not np.array_equal(np.asarray(old_flat[p]),
                                             np.asarray(new_flat[p]))}
        port_changed = {k for k in before if not torch.equal(before[k], after[k])}
        assert port_changed == jax_changed, (name, sorted(port_changed ^ jax_changed))
        for k in port_changed:
            assert after[k].dtype == before[k].dtype
        if name == model:
            zeroed = torch_key_for((layer, "kernel"))
            assert zeroed not in port_changed and not after[zeroed].any()


def test_draws_have_torch_default_statistics():
    """Weights of at least 10,000 values: within ±1/√fan_in, standard
    deviation within 5 % of 1/√(3·fan_in); embedding tables N(0, 1)."""
    _, tp, _ = shared_pair("2.1")
    pipe = copy.deepcopy(tp)
    gen = torch.Generator().manual_seed(1)
    checked = {"kernel": 0, "embedding": 0}
    for module in pipe.models().values():
        torch_init_stats(module, gen)
        for mod in module.modules():
            w = getattr(mod, "weight", None)
            if w is None or w.numel() < 10000:
                continue
            w = w.detach()
            if isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)):
                b = w[0].numel() ** -0.5
                assert float(w.abs().max()) <= b
                assert float(w.std()) == pytest.approx(b / 3 ** 0.5, rel=0.05)
                checked["kernel"] += 1
            elif isinstance(mod, torch.nn.Embedding):
                assert float(w.std()) == pytest.approx(1.0, rel=0.05)
                assert abs(float(w.mean())) < 0.05
                checked["embedding"] += 1
    assert checked["kernel"] > 10 and checked["embedding"] >= 1, checked
