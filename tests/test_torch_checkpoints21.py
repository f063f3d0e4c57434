"""The port's 2.1 and 2.0 checkpoint path (``weights/hub.fetch_2_1`` and
``fetch_2_0``, ``weights/load_kandinsky``, ``get_kandinsky2``) against the
JAX package's loaders, on synthetic checkpoints in the reference's files
and layout: numpy-seeded values of the JAX pipelines at ``small_config``
and ``small_config20`` (the port's default configs patched to those),
``torch.save``d (the decoder in fp16, the prior in bf16 under
``{"state_dict": {"model.*"}}``), the OpenAI CLIP towers as a
``torch.jit.save``d archive with fused ``attn.in_proj_weight`` and
``visual.`` keys.  Every loaded port tensor is bitwise equal to the bridge
of what JAX's loaders return, a tiny seeded text2img agrees within the
end-to-end tolerance, the inpainting task reads its own checkpoint, a
missing file names itself, and a missing tokenizer is named."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from kandinsky2_tpu.pipelines.kandinsky2_0 import Kandinsky2 as J20
from kandinsky2_tpu.pipelines.kandinsky2_1 import Kandinsky2_1 as J21
from kandinsky2_tpu.weights import load_kandinsky as jload
from kandinsky2_tpu.weights.convert import convert_state_dict
from kandinsky2_tpu_torch import get_kandinsky2
from kandinsky2_tpu_torch.configs import small_config, small_config20
from kandinsky2_tpu_torch.pipelines import kandinsky2_0 as tpipe20
from kandinsky2_tpu_torch.pipelines import kandinsky2_1 as tpipe21
from kandinsky2_tpu_torch.utils import stub_tokenizers
from kandinsky2_tpu_torch.weights.convert import clip_rename
from kandinsky2_tpu_torch.weights.from_jax import jax_to_state_dict
from test_torch_checkpoints22 import reference_state_dict
from test_torch_common import (
    assert_images,
    capture_jax_floats,
    capture_jax_floats20,
    numpy_params,
    seeded_noise,
)

PROMPT = "red sand dunes under a violet sky"


def torch_sd(tree, dtype=torch.float32, prefix="", rename=None):
    return {prefix + k: torch.from_numpy(v).to(dtype)
            for k, v in reference_state_dict(tree, rename=rename).items()}


def save_jit_archive(sd, path):
    """A TorchScript archive whose state dict is ``sd``, as OpenAI's CLIP
    files are."""

    class Holder(nn.Module):
        def forward(self):
            return 0

    root = Holder()
    for key, value in sd.items():
        *names, leaf = key.split(".")
        mod = root
        for name in names:
            if not hasattr(mod, name):
                mod.add_module(name, Holder())
            mod = getattr(mod, name)
        mod.register_buffer(leaf, value.clone())
    torch.jit.save(torch.jit.script(root), path)


def _params(jp, seed, conv_out):
    params = numpy_params(jax.eval_shape(jp.init_random_params, jax.random.PRNGKey(0)),
                          seed)
    tree = params
    for name in conv_out[:-1]:
        tree = tree[name]
    tree[conv_out[-1]]["kernel"] = tree[conv_out[-1]]["kernel"] * np.float32(0.01)
    return params


def write_cache21(cache, tok1, tok2):
    """<cache>/2_1 with ``decoder_fp16.ckpt`` and ``inpainting_fp16.ckpt``;
    returns the JAX pipeline's (clip_mean, clip_std, text2img params,
    inpainting UNet params)."""
    cd = os.path.join(cache, "2_1")
    os.makedirs(os.path.join(cd, "text_encoder"))
    clip_dim = small_config()["prior"]["params"]["model"]["hparams"]["clip_dim"]
    rng = np.random.RandomState(40)
    mean = (0.1 * rng.randn(clip_dim)).astype(np.float32)
    std = (1 + 0.1 * rng.rand(clip_dim)).astype(np.float32)
    kw = dict(config=small_config(), tokenizer1=tok1, tokenizer2=tok2, clip_mean=mean,
              clip_std=std, dtype=jnp.float32)
    params = _params(J21(**kw), 41, ("movq", "decoder", "conv_out"))
    inpaint = _params(J21(task_type="inpainting", **kw), 42, ("movq", "decoder", "conv_out"))
    torch.save(torch_sd(params["unet"], torch.float16), os.path.join(cd, "decoder_fp16.ckpt"))
    torch.save(torch_sd(inpaint["unet"], torch.float16),
               os.path.join(cd, "inpainting_fp16.ckpt"))
    torch.save({"state_dict": torch_sd(params["prior"], torch.bfloat16, prefix="model.")},
               os.path.join(cd, "prior_fp16.ckpt"))
    torch.save(torch_sd(params["movq"]), os.path.join(cd, "movq_final.ckpt"))
    torch.save(torch_sd(params["text_encoder"]["model"]),
               os.path.join(cd, "text_encoder", "pytorch_model.bin"))
    clip = torch_sd(params["clip_text"], rename=clip_rename)
    clip.update(torch_sd(params["clip_vision"], prefix="visual.", rename=clip_rename))
    save_jit_archive(clip, os.path.join(cd, "ViT-L-14.pt"))
    torch.save((torch.from_numpy(mean), torch.from_numpy(std)),
               os.path.join(cd, "ViT-L-14_stats.th"))
    return kw, params, inpaint


def zeros(tree):
    """A tree of zeros, so that a key a loader misses shows."""
    return jax.tree_util.tree_map(np.zeros_like, tree)


def jax_text_encoder(model_dir, shapes):
    """The XLM-R text encoder's tree as JAX's ``convert_state_dict`` reads
    ``<model_dir>/pytorch_model.bin`` (keys ``transformer.*`` and
    ``LinearTransformation.*``) onto the TextEncoder's ``model`` subtree.
    JAX's ``load_text_encoder21`` strips ``model.`` from keys that lack it
    and so loads none of them (``test_jax_text_encoder_loader_fault``)."""
    return {"model": convert_state_dict(
        jload._load_sd(os.path.join(model_dir, "pytorch_model.bin")),
        zeros(shapes["model"]), strict=True)}


def jax_load21(cd, shapes, task_type="text2img"):
    """JAX's build_kandinsky21 without its tokenizers: each loader on the
    same files, onto trees of zeros."""
    decoder = "decoder_fp16.ckpt" if task_type == "text2img" else "inpainting_fp16.ckpt"
    shapes = zeros(shapes)
    out = {
        "unet": jload.load_unet21(os.path.join(cd, decoder), shapes["unet"]),
        "prior": jload.load_prior21(os.path.join(cd, "prior_fp16.ckpt"), shapes["prior"]),
        "movq": jload.load_movq(os.path.join(cd, "movq_final.ckpt"), shapes["movq"]),
        "text_encoder": jax_text_encoder(os.path.join(cd, "text_encoder"),
                                         shapes["text_encoder"]),
    }
    out["clip_text"], out["clip_vision"] = jload.load_clip_vit_l14(
        os.path.join(cd, "ViT-L-14.pt"), shapes["clip_text"], shapes["clip_vision"])
    return out


def assert_bitwise(jtrees, pipe):
    for name, model in pipe.models().items():
        want = jax_to_state_dict(jtrees[name], model)
        got = model.state_dict()
        assert set(got) == set(want), name
        for key, value in want.items():
            assert torch.equal(got[key], value), f"{name} {key}"


@pytest.fixture(scope="module")
def cache21(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("k21_cache"))
    tok1, tok2 = stub_tokenizers()
    kw, params, inpaint = write_cache21(cache, tok1, tok2)
    return cache, (tok1, tok2), kw, params, inpaint


@pytest.fixture
def small_defaults(monkeypatch):
    """The port pipelines' default configs at the tests' small ones."""
    monkeypatch.setattr(tpipe21, "CONFIG_2_1", small_config())
    monkeypatch.setattr(tpipe20, "CONFIG_2_0", small_config20())


@pytest.mark.parametrize("task_type", ["text2img", "inpainting"])
def test_21_weights_bitwise_equal_jax(cache21, small_defaults, task_type):
    cache, toks, _, params, inpaint = cache21
    tp = get_kandinsky2("cpu", task_type=task_type, cache_dir=cache, model_version="2.1",
                        dtype=torch.float32, tokenizers=toks)
    assert tp.task_type == task_type and tp.device.type == "cpu"
    assert tp.unet.input_blocks[0][0].weight.shape[1] == (9 if task_type == "inpainting"
                                                          else 4)
    shapes = dict(params, unet=(inpaint if task_type == "inpainting" else params)["unet"])
    assert_bitwise(jax_load21(os.path.join(cache, "2_1"), shapes, task_type), tp)
    mean, std = jload.load_clip_stats(os.path.join(cache, "2_1", "ViT-L-14_stats.th"))
    assert np.array_equal(tp.clip_mean.numpy()[0], mean)
    assert np.array_equal(tp.clip_std.numpy()[0], std)


def test_21_tiny_text2img_matches_jax(cache21, small_defaults, monkeypatch):
    cache, toks, kw, params, _ = cache21
    cd = os.path.join(cache, "2_1")
    mean, std = jload.load_clip_stats(os.path.join(cd, "ViT-L-14_stats.th"))
    jp = J21(**dict(kw, clip_mean=mean, clip_std=std))
    jp.params = jax.tree_util.tree_map(jnp.asarray, jax_load21(cd, params))
    tp = get_kandinsky2("cpu", cache_dir=cache, model_version="2.1", dtype=torch.float32,
                        tokenizers=toks)
    capture_jax_floats(monkeypatch)
    clip_dim = mean.shape[0]
    args = dict(num_steps=4, guidance_scale=4, h=64, w=64, sampler="ddim_sampler",
                prior_cf_scale=4, prior_steps="3", noise=seeded_noise(0, 1, 8, 8, 4),
                prior_noise=seeded_noise(1, 1, clip_dim),
                prior_noise_seq=seeded_noise(2, 3, 1, clip_dim))
    want = jp.generate_text2img(PROMPT, **args)
    got = tp.generate_text2img(PROMPT, output="float", **args)
    assert_images(got, want, "2.1 text2img from the checkpoints")


def test_21_missing_files_and_tokenizers(cache21, small_defaults, tmp_path):
    cache, toks, _, _, _ = cache21
    with pytest.raises(FileNotFoundError) as err:
        get_kandinsky2("cpu", cache_dir=str(tmp_path), model_version="2.1", tokenizers=toks)
    assert "decoder_fp16.ckpt" in str(err.value) and "Kandinsky_2.1" in str(err.value)
    with pytest.raises(ValueError, match="tokenizer1 .*XLM-R"):
        get_kandinsky2("cpu", cache_dir=cache, model_version="2.1")
    # no CLIP tokenizer given and no BPE vocabulary cached: named
    with pytest.raises(FileNotFoundError, match="bpe_simple_vocab_16e6"):
        get_kandinsky2("cpu", cache_dir=cache, model_version="2.1",
                       tokenizers=(toks[0], None))
    with pytest.raises(ValueError, match="Only 2.0, 2.1 and 2.2"):
        get_kandinsky2("cpu", cache_dir=cache, model_version="3.0")


@pytest.fixture(scope="module")
def cache20(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("k20_cache"))
    cd = os.path.join(cache, "2_0")
    for sub in ("text_encoder1", "text_encoder2"):
        os.makedirs(os.path.join(cd, sub))
    tok, _ = stub_tokenizers(64)
    kw = dict(config=small_config20(), tokenizer1=tok, tokenizer2=tok, dtype=jnp.float32)
    params = _params(J20(**kw), 43, ("image_encoder", "decoder", "conv_out"))
    torch.save({"state_dict": torch_sd(params["unet"], torch.float16)},
               os.path.join(cd, "Kandinsky-2-0.pt"))
    torch.save(torch_sd(params["image_encoder"], torch.bfloat16), os.path.join(cd, "vae.ckpt"))
    torch.save(torch_sd(params["text_encoder1"]["model"]),
               os.path.join(cd, "text_encoder1", "pytorch_model.bin"))
    torch.save(torch_sd(params["text_encoder2"]),
               os.path.join(cd, "text_encoder2", "pytorch_model.bin"))
    # JAX's build_kandinsky20 without its tokenizers, onto trees of zeros
    shapes = zeros(params)
    jtrees = {
        "unet": convert_state_dict(jload._load_sd(os.path.join(cd, "Kandinsky-2-0.pt")),
                                   shapes["unet"], strict=False),
        "image_encoder": convert_state_dict(jload._load_sd(os.path.join(cd, "vae.ckpt")),
                                            shapes["image_encoder"], strict=False),
        "text_encoder1": jax_text_encoder(os.path.join(cd, "text_encoder1"),
                                          shapes["text_encoder1"]),
        "text_encoder2": convert_state_dict(
            jload._load_sd(os.path.join(cd, "text_encoder2", "pytorch_model.bin")),
            shapes["text_encoder2"], strict=False),
    }
    return cache, tok, kw, jtrees


def test_20_weights_and_text2img_match_jax(cache20, small_defaults, monkeypatch):
    cache, tok, kw, jtrees = cache20
    tp = get_kandinsky2("cpu", cache_dir=cache, model_version="2.0", dtype=torch.float32,
                        tokenizers=(tok, tok))
    assert_bitwise(jtrees, tp)
    jp = J20(**kw)
    jp.params = jax.tree_util.tree_map(jnp.asarray, jtrees)
    capture_jax_floats20(monkeypatch)
    args = dict(num_steps=4, guidance_scale=4, h=64, w=64, sampler="ddim_sampler",
                ddim_eta=0.0, noise=seeded_noise(5, 1, 8, 8, 4))
    want = jp.generate_text2img(PROMPT, **args)
    got = tp.generate_text2img(PROMPT, output="float", **args)
    assert_images(got, want, "2.0 text2img from the checkpoints")


def test_20_missing_files_and_tokenizers(cache20, small_defaults, tmp_path):
    cache, tok, _, _ = cache20
    with pytest.raises(ValueError, match="tokenizer2 .*mT5"):
        get_kandinsky2("cpu", cache_dir=cache, model_version="2.0", tokenizers=(tok, None))
    with pytest.raises(FileNotFoundError, match="Kandinsky-2-0-inpainting.pt"):
        get_kandinsky2("cpu", task_type="inpainting", cache_dir=cache, model_version="2.0",
                       tokenizers=(tok, tok))
    with pytest.raises(FileNotFoundError, match="vae.ckpt"):
        os.makedirs(tmp_path / "2_0")
        torch.save({}, tmp_path / "2_0" / "Kandinsky-2-0.pt")
        get_kandinsky2("cpu", cache_dir=str(tmp_path), model_version="2.0",
                       tokenizers=(tok, tok))


def test_jax_text_encoder_loader_fault(cache21, small_defaults):
    """JAX's ``load_text_encoder21`` hands ``convert_state_dict`` the
    TextEncoder's ``model`` subtree, whose keys (``transformer.*``) lack the
    ``model.`` its rename strips: it matches no key of the file and,
    non-strict, leaves every tensor as it was.  The port strips ``model.``
    from the TextEncoder's own keys and loads every one."""
    cache, toks, _, params, _ = cache21
    model_dir = os.path.join(cache, "2_1", "text_encoder")
    untouched = jload.load_text_encoder21(model_dir, zeros(params["text_encoder"]["model"]))
    assert all(not np.any(v) for v in jax.tree_util.tree_leaves(untouched))
    tp = get_kandinsky2("cpu", cache_dir=cache, model_version="2.1", dtype=torch.float32,
                        tokenizers=toks)
    sd = torch.load(os.path.join(model_dir, "pytorch_model.bin"))
    got = tp.text_encoder.state_dict()
    assert len(sd) == len(got)
    assert all(torch.equal(got["model." + k], v) for k, v in sd.items())
