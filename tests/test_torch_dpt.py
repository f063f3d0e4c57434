"""The port's DPT depth network (``kandinsky2_tpu_torch/models/dpt.py``)
and its estimator (``depth.dpt_estimator``) against the JAX package's, at
``tests/test_dpt_parity.py``'s tiny configurations: ``TINY`` (pure ViT)
and ``TINY_HYBRID`` (BiT stem, ``TINY_BIT``).

* The module: the same numpy-seeded parameters through the bridge, fp32,
  within 1e-4 (also on a 128² input, where the position embeddings are
  resized).
* The checkpoint: a transformers ``DPTForDepthEstimation`` state dict (the
  published layout: 1x1 convs as OI11, the transposed convs as [in, out,
  k, k]) through JAX's ``convert_state_dict`` and the port's loader, every
  port tensor bitwise equal to the bridge of JAX's tree.
* The estimator: a snapshot (config.json + model.safetensors) through both
  ``dpt_estimator``s on one PIL image (both resize it with PIL's bicubic),
  within 1e-4 of the depth's largest value; ``default_estimator`` picks it
  and ``make_hint`` takes it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from transformers import DPTConfig, DPTForDepthEstimation

from kandinsky2_tpu import depth as jdepth
from kandinsky2_tpu.models import dpt as jdpt
from kandinsky2_tpu.weights.convert import convert_state_dict
from kandinsky2_tpu_torch import depth as tdepth
from kandinsky2_tpu_torch.models import dpt as tdpt
from kandinsky2_tpu_torch.weights.convert import load_state_dict
from kandinsky2_tpu_torch.weights.from_jax import jax_to_state_dict, load_jax_params
from kandinsky2_tpu_torch.weights.safetensors_file import save_file
from test_dpt_parity import TINY, TINY_HYBRID
from test_torch_common import MODULE_TOL, assert_close, numpy_params

CONFIGS = {"vit": TINY, "hybrid": TINY_HYBRID}


def _jax_module(cfg):
    module = jdpt.DPTDepth(**jdpt.dpt_overrides(dict(cfg)))
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"])
    return module, shapes


def _hf_state_dict(cfg, seed):
    """A transformers DPT's state dict, every parameter moved off its init."""
    torch.manual_seed(seed)
    model = DPTForDepthEstimation(DPTConfig(**cfg)).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.02)
    return {k: v.detach().contiguous() for k, v in model.state_dict().items()}


def test_overrides_match_jax():
    for cfg in CONFIGS.values():
        assert tdpt.dpt_overrides(dict(cfg)) == jdpt.dpt_overrides(dict(cfg))
    bad = dict(TINY_HYBRID, backbone_config=dict(TINY_HYBRID["backbone_config"],
                                                 global_padding="valid"))
    with pytest.raises(ValueError, match="SAME"):
        tdpt.dpt_overrides(bad)


@pytest.mark.parametrize("family,size", [("vit", 64), ("vit", 128), ("hybrid", 64)])
def test_dpt_matches_jax(family, size):
    module, shapes = _jax_module(CONFIGS[family])
    params = numpy_params(shapes, 3)
    x = np.random.RandomState(4).randn(2, size, size, 3).astype(np.float32)
    want = jax.jit(module.apply)({"params": params}, x)
    tm = load_jax_params(tdpt.DPTDepth(**tdpt.dpt_overrides(dict(CONFIGS[family]))),
                         params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert np.asarray(want).shape == (2, size, size)
    assert float(np.asarray(want).std()) > 1e-3
    assert_close(got, want, MODULE_TOL, f"{family} {size}")


@pytest.mark.parametrize("family", ["vit", "hybrid"])
def test_checkpoint_loads_bitwise_like_jax(family):
    cfg = CONFIGS[family]
    sd = _hf_state_dict(cfg, 5)
    module, shapes = _jax_module(cfg)
    jtree = convert_state_dict({k: v.numpy() for k, v in sd.items()}, shapes, strict=True)
    tm = tdpt.DPTDepth(**tdpt.dpt_overrides(dict(cfg)))
    load_state_dict(tm, sd, strict=True)
    want = jax_to_state_dict(jtree, tm)
    got = tm.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    with pytest.raises(KeyError, match="missing"):
        load_state_dict(tm, {k: v for k, v in sd.items() if "head" not in k}, strict=True)


def _live_state_dict(cfg, seed):
    """A transformers DPT's state dict holding ``numpy_params``' values
    (whose depth is not relu'd to zero), in the transformers layout."""
    sd = _hf_state_dict(cfg, seed)
    module, shapes = _jax_module(cfg)
    tm = load_jax_params(tdpt.DPTDepth(**tdpt.dpt_overrides(dict(cfg))),
                         numpy_params(shapes, seed))
    live = tm.state_dict()
    return {k: live[k].reshape(v.shape).contiguous() if k in live else v
            for k, v in sd.items()}


@pytest.mark.parametrize("family", ["vit", "hybrid"])
def test_estimator_matches_jax(family, tmp_path, monkeypatch):
    cfg = CONFIGS[family]
    repo = tmp_path / family
    repo.mkdir()
    (repo / "config.json").write_text(json.dumps(dict(cfg, model_type="dpt")))
    save_file(_live_state_dict(cfg, 6), str(repo / "model.safetensors"))
    img = Image.fromarray(np.random.default_rng(7).integers(
        0, 256, (90, 70, 3), dtype=np.uint8))
    want = jdepth.dpt_estimator(str(repo))(img)
    est = tdepth.dpt_estimator(str(repo), device="cpu")
    got = est(img)
    assert got.shape == want.shape == (64, 64) and got.dtype == np.float32
    assert float(want.std()) > 0
    assert_close(got, want, MODULE_TOL, family)
    monkeypatch.setenv("KANDINSKY2_DPT_DIR", str(repo))
    monkeypatch.setattr(tdepth, "dpt_estimator", lambda repo_dir: ("dpt", repo_dir))
    assert tdepth.default_estimator() == ("dpt", str(repo))
    hint = tdepth.make_hint(img, h=32, w=32, estimator=est)
    assert hint.shape == (32, 32, 3) and 0.0 <= hint.min() and hint.max() <= 1.0


def test_fetch_dpt_finds_the_cached_snapshot(tmp_path):
    """``hub.fetch_dpt``: the JAX package's cache layout, and a missing file
    named with its repo."""
    from kandinsky2_tpu.weights import hub as jhub
    from kandinsky2_tpu_torch.weights import hub

    assert (hub.DPT_REPO, hub.DPT_LARGE_REPO) == (jhub.DPT_REPO, jhub.DPT_LARGE_REPO)
    repo = tmp_path / "dpt" / "Intel__dpt-large"
    repo.mkdir(parents=True)
    (repo / "config.json").write_text(json.dumps(dict(TINY, model_type="dpt")))
    with pytest.raises(FileNotFoundError, match="model.safetensors or pytorch_model.bin"):
        hub.fetch_dpt(str(tmp_path), hub.DPT_LARGE_REPO)
    save_file(_hf_state_dict(TINY, 8), str(repo / "model.safetensors"))
    got = hub.fetch_dpt(str(tmp_path), hub.DPT_LARGE_REPO)
    assert got == jhub.fetch_dpt(str(tmp_path), jhub.DPT_LARGE_REPO) == str(repo)
    with pytest.raises(FileNotFoundError, match="Intel/dpt-hybrid-midas"):
        hub.fetch_dpt(str(tmp_path))
