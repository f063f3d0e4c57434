"""The port's 2.2 checkpoint path (``weights/hub.fetch_2_2``,
``weights/configs22``' snapshot half, ``weights/load_kandinsky22``,
``get_kandinsky2(model_version="2.2")``) against the JAX package's, on the
synthetic diffusers snapshots of ``tests/test_factory22.py`` (its tiny
config.json files and byte-level tokenizer; values drawn by
``test_torch_common.numpy_params`` and written in the torch layout, the
prior's in F16): every loaded port tensor bitwise equal to the bridge of
what JAX's factory loaded, the snapshot overrides equal, the task ->
decoder repo routing and a missing file naming itself, a tiny seeded
text2img within the end-to-end tolerance, and the safetensors codec's F32,
F16 and BF16 round trips bit for bit (against the ``safetensors``
package)."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from kandinsky2_tpu import get_kandinsky2 as jget
from kandinsky2_tpu.pipelines.kandinsky2_2 import Kandinsky2_2 as J22
from kandinsky2_tpu.weights import configs22 as jcfg
from kandinsky2_tpu.weights.convert import torch_key_for
from kandinsky2_tpu.weights.load_kandinsky22 import movq22_rename as jrename
from kandinsky2_tpu_torch import get_kandinsky2
from kandinsky2_tpu_torch.weights import configs22 as tcfg
from kandinsky2_tpu_torch.weights import hub
from kandinsky2_tpu_torch.weights import safetensors_file as sf
from kandinsky2_tpu_torch.weights.from_jax import flatten, jax_to_state_dict
from kandinsky2_tpu_torch.weights.load_kandinsky22 import movq22_rename
from test_factory22 import (
    TINY_MOVQ,
    TINY_PRIOR,
    TINY_TEXT,
    TINY_UNET,
    TINY_VISION,
    _inverse_transform,
    _write_json,
    _write_tokenizer,
)
from test_torch_common import assert_images, capture_jax_floats22, numpy_params, seeded_noise

PROMPT = "red sand dunes under a violet sky"


def reference_state_dict(tree, rename=None, dtype=np.float32):
    """A flax tree's values as a torch-layout state dict."""
    sd = {}
    for path, value in flatten(tree).items():
        key = torch_key_for(path)
        sd[rename(key) if rename else key] = _inverse_transform(
            np.asarray(value, np.float32), path[-1]).astype(dtype)
    return sd


def write_snapshots(cache):
    """<cache>/2_2/{prior,decoder}: the tiny configs, the tokenizer and
    numpy-seeded weights (the MoVQ's output conv at 0.01 and clip_std
    around 1, as ``parity_pipelines22`` draws them)."""
    cd = os.path.join(cache, "2_2")
    prior_dir, decoder_dir = os.path.join(cd, "prior"), os.path.join(cd, "decoder")
    for d, sub, cfg in [(prior_dir, "prior", TINY_PRIOR), (prior_dir, "text_encoder", TINY_TEXT),
                        (prior_dir, "image_encoder", TINY_VISION),
                        (decoder_dir, "unet", TINY_UNET), (decoder_dir, "movq", TINY_MOVQ)]:
        _write_json(os.path.join(d, sub, "config.json"), cfg)
    _write_tokenizer(os.path.join(prior_dir, "tokenizer"))
    overrides = jcfg.pipeline_overrides(prior_dir, decoder_dir, "text2img")
    shapes = jax.eval_shape(J22(task_type="text2img", dtype=jnp.float32,
                                overrides=overrides).init_random_params)
    params = numpy_params(shapes, 31)
    params["prior"]["clip_std"] = np.abs(1.0 + params["prior"]["clip_std"])
    conv_out = params["movq"]["decoder"]["conv_out"]
    conv_out["kernel"] = conv_out["kernel"] * np.float32(0.01)
    files = {
        ("unet", decoder_dir, "diffusion_pytorch_model"): reference_state_dict(params["unet"]),
        ("movq", decoder_dir, "diffusion_pytorch_model"): reference_state_dict(
            params["movq"], rename=jrename),
        ("prior", prior_dir, "diffusion_pytorch_model"): reference_state_dict(
            params["prior"], dtype=np.float16),
        ("image_encoder", prior_dir, "model"): reference_state_dict(params["image_encoder"]),
        ("text_encoder", prior_dir, "model"): reference_state_dict(params["text_encoder"]),
    }
    for (sub, d, stem), sd in files.items():
        np_save_file(sd, os.path.join(d, sub, f"{stem}.safetensors"))
    return prior_dir, decoder_dir


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("k22_cache"))
    prior_dir, decoder_dir = write_snapshots(cache)
    jp = jget(task_type="text2img", model_version="2.2", cache_dir=cache,
              dtype=jnp.float32)
    tp = get_kandinsky2("cpu", task_type="text2img", model_version="2.2", cache_dir=cache,
                        dtype=torch.float32)
    return cache, prior_dir, decoder_dir, jp, tp


def test_weights_bitwise_equal_jax(loaded):
    _, _, _, jp, tp = loaded
    assert tp.device.type == "cpu" and tp.tokenizer is not None
    for name, model in tp.models().items():
        want = jax_to_state_dict(jp.params[name], model)
        got = model.state_dict()
        assert set(got) == set(want), name
        for key, value in want.items():
            assert got[key].dtype == torch.float32
            assert torch.equal(got[key], value), f"{name} {key}"


def test_snapshot_overrides_equal_jax(loaded):
    _, prior_dir, decoder_dir, _, _ = loaded
    unet_sd = tcfg_sd = sf.load_torch(os.path.join(
        decoder_dir, "unet", "diffusion_pytorch_model.safetensors"))
    want = jcfg.pipeline_overrides(prior_dir, decoder_dir, "text2img",
                                   unet_sd={k: v.numpy() for k, v in unet_sd.items()})
    got = tcfg.pipeline_overrides(prior_dir, decoder_dir, "text2img", unet_sd=tcfg_sd)
    for ov in (want, got):
        assert ov["image_encoder"].pop("act").__name__ == "exact_gelu"
    assert got == want
    assert got["unet"]["num_image_tokens"] == 2 and got["unet"]["block_out_channels"] == (32, 64)
    assert tcfg.derive_num_image_tokens({}, 32) is None
    with pytest.raises(ValueError):
        tcfg.derive_num_image_tokens({"encoder_hid_proj.image_embeds.weight":
                                      np.zeros((33, 4))}, 32)
    # the eos 2 repair, the quick_gelu vision tower and the prior's order
    text = dict(TINY_TEXT, eos_token_id=2)
    assert tcfg.clip_text_overrides(text) == jcfg.clip_text_overrides(text)
    assert tcfg.clip_text_overrides(text)["eot_token_id"] == 513
    vision = dict(TINY_VISION, hidden_act="quick_gelu")
    assert tcfg.clip_vision_overrides(vision)["act"].__name__ == "quick_gelu"
    order = dict(TINY_PRIOR, embedding_order=["x", "text", "proj", "time", "prd"])
    assert tcfg.prior22_overrides(order) == jcfg.prior22_overrides(order)


def test_movq_rename_matches_jax(loaded):
    keys = list(loaded[4].movq.state_dict())
    assert len(keys) > 50
    assert [movq22_rename(k) for k in keys] == [jrename(k) for k in keys]


def test_tiny_text2img_matches_jax(loaded, monkeypatch):
    _, _, _, jp, tp = loaded
    capture_jax_floats22(monkeypatch)
    kw = dict(decoder_steps=3, prior_steps=2, h=64, w=64,
              noise=seeded_noise(0, 1, 8, 8, 4), prior_noise=seeded_noise(1, 1, 32),
              noise_seq=seeded_noise(2, 3, 1, 8, 8, 4),
              prior_noise_seq=seeded_noise(3, 2, 1, 32))
    want = jp.generate_text2img(PROMPT, **kw)
    got = tp.generate_text2img(PROMPT, output="float", **kw)
    assert_images(got, want, "2.2 text2img from the snapshots")


def test_fetch_routes_tasks_and_names_missing_files(loaded, tmp_path):
    cache = loaded[0]
    assert hub._DECODER_KEY_BY_TASK == {"text2img": "decoder", "img2img": "decoder",
                                        "inpainting": "decoder-inpaint",
                                        "controlnet": "controlnet-depth"}
    paths = hub.fetch_2_2(cache, "img2img")
    assert paths["decoder_dir"].endswith(os.path.join("2_2", "decoder"))
    assert paths["tokenizer_dir"] == os.path.join(paths["prior_dir"], "tokenizer")
    # no decoder-inpaint snapshot: the inpainting task must not fall back to
    # the base decoder
    for task, key in [("inpainting", "decoder-inpaint"), ("controlnet", "controlnet-depth")]:
        with pytest.raises(FileNotFoundError) as err:
            hub.fetch_2_2(cache, task)
        assert os.path.join("2_2", key, "unet", "config.json") in str(err.value)
        assert hub.KANDINSKY_22_REPOS[key] in str(err.value)
    with pytest.raises(ValueError):
        hub.fetch_2_2(cache, "style_transfer")
    # a weights file missing: named with both alternatives
    copy = tmp_path / "cache"
    shutil.copytree(cache, copy)
    os.remove(copy / "2_2" / "decoder" / "movq" / "diffusion_pytorch_model.safetensors")
    with pytest.raises(FileNotFoundError, match="diffusion_pytorch_model.safetensors or "
                       "diffusion_pytorch_model.bin"):
        get_kandinsky2("cpu", model_version="2.2", cache_dir=str(copy))
    # the .bin export is the second choice, through torch.load
    sd = sf.load_torch(os.path.join(cache, "2_2", "decoder", "movq",
                                    "diffusion_pytorch_model.safetensors"))
    torch.save(sd, copy / "2_2" / "decoder" / "movq" / "diffusion_pytorch_model.bin")
    tp = get_kandinsky2("cpu", model_version="2.2", cache_dir=str(copy),
                        dtype=torch.float32)
    for key, value in loaded[4].movq.state_dict().items():
        assert torch.equal(tp.movq.state_dict()[key], value), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_round_trip_bitwise(dtype, tmp_path):
    """The port's writer and reader against the ``safetensors`` package, in
    both directions, bit for bit; numpy arrays of F32 and F16 too, and BF16
    read into numpy as its exact float32 widening."""
    from safetensors.torch import load_file as pkg_load, save_file as pkg_save

    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(7, 5, generator=g).to(dtype),
               "b": (torch.randn(3, generator=g) * 1e4).to(dtype),
               "empty": torch.zeros(0, 4, dtype=dtype)}
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    sf.save_file(tensors, ours)
    pkg_save(tensors, theirs)
    for path in (ours, theirs):
        for got in (sf.load_torch(path), pkg_load(path)):
            assert set(got) == set(tensors)
            for k, v in tensors.items():
                assert got[k].dtype == dtype and torch.equal(got[k], v), (path, k)
        as_numpy = sf.load_file(path)
        for k, v in tensors.items():
            assert np.array_equal(as_numpy[k], v.float().numpy() if dtype == torch.bfloat16
                                  else v.numpy())
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    if dtype != torch.bfloat16:
        arrays = {k: v.numpy() for k, v in tensors.items()}
        sf.save_file(arrays, ours)
        assert all(np.array_equal(sf.load_file(ours)[k], v) for k, v in arrays.items())
    with pytest.raises(TypeError):
        sf.save_file({"x": torch.zeros(2, dtype=torch.float64)}, ours)
