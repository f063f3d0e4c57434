"""Shared helpers for the parity tests of the PyTorch port against the JAX
package: the ``bench.py --small`` configuration (the port's
``small_config``, which both packages read), parameters drawn from a numpy
seed (every leaf non-zero, including the leaves flax initialises to zero),
and conversions between the two frameworks."""

import functools
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
# the tiny 2.1 UNet of tests/test_checkpoint_resume.py (32 channels, mult
# 1,2, 16-wide heads), over CONFIG_2_1's model_config
TINY_UNET = dict(
    num_channels=32, num_res_blocks=1, channel_mult="1,2",
    attention_resolutions="32", num_head_channels=16, model_dim=32,
    text_encoder_in_dim1=16, text_encoder_in_dim2=32, image_encoder_in_dim=32,
    num_image_embs=2,
)


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
    """The tests hand the port's configs to both packages, so its copies of
    ``CONFIG_2_1`` and ``CONFIG_2_0`` must be the JAX package's."""
    assert torch_configs.CONFIG_2_1 == jax_configs.CONFIG_2_1
    assert torch_configs.CONFIG_2_0 == jax_configs.CONFIG_2_0


def test_small_config20_is_the_jax_tests_tiny_config():
    from test_pipeline20 import tiny_config20 as jax_tiny

    assert torch_configs.small_config20() == jax_tiny()


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


# --- the 2.1 pipeline in both frameworks --------------------------------------


def parity_pipelines(task_type="text2img", seed=12, head_channels=32,
                     jax_dtype=None, torch_dtype=torch.float32, unet_out_scale=1.0):
    """(JAX pipeline, port pipeline on the CPU, params) at
    ``small_config(head_channels)`` with the same numpy-seeded parameters,
    the JAX one in fp32 unless ``jax_dtype`` says otherwise.  The MoVQ's
    output conv is scaled by 0.01, since random weights leave the image at
    |x| ~ 1e2 and the absolute image tolerance is set for [-1, 1]; the
    UNet's by ``unet_out_scale``, which only the hires case sets (see
    ``test_torch_tasks21_image.py``)."""
    import jax.numpy as jnp

    import kandinsky2_tpu.pipelines.kandinsky2_1 as jpipe_mod
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
    from kandinsky2_tpu_torch.utils import stub_tokenizers

    cfg = small_config(head_channels)
    tok1, tok2 = stub_tokenizers()
    clip_dim = cfg["prior"]["params"]["model"]["hparams"]["clip_dim"]
    rng = np.random.RandomState(11)
    clip_mean = (0.1 * rng.randn(clip_dim)).astype(np.float32)
    clip_std = (1 + 0.1 * rng.rand(clip_dim)).astype(np.float32)
    kw = dict(config=cfg, tokenizer1=tok1, tokenizer2=tok2, clip_mean=clip_mean,
              clip_std=clip_std, task_type=task_type)
    jp = jpipe_mod.Kandinsky2_1(dtype=jax_dtype or jnp.float32, **kw)
    params = numpy_params(
        jax.eval_shape(jp.init_random_params, jax.random.PRNGKey(0)), seed)
    conv_out = params["movq"]["decoder"]["conv_out"]
    conv_out["kernel"] = conv_out["kernel"] * np.float32(0.01)
    unet_out = params["unet"]["out.2"]
    unet_out["kernel"] = unet_out["kernel"] * np.float32(unet_out_scale)
    jp.params = jax.tree_util.tree_map(jnp.asarray, params)
    tp = Kandinsky2_1(dtype=torch_dtype, device="cpu", **kw)
    tp.load_jax_params(params)
    return jp, tp, params


def assert_images(got, want, what):
    """A float image of the port against the JAX pipeline's (an array, or
    the ``JaxImages`` of ``capture_jax_floats``) at ``E2E_TOL``."""
    want = np.asarray(want.floats if hasattr(want, "floats") else want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all() and np.std(got) > 1e-3, what
    assert np.abs(want).max() < 10, what
    err = float(np.abs(got - want).max())
    assert err <= E2E_TOL, f"{what}: max abs err {err:.3e}"


def seeded_noise(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


class JaxImages(list):
    """The JAX pipeline's PIL images, with the float images they came from
    in ``floats``."""

    floats: np.ndarray


def capture_jax_floats(monkeypatch):
    """Make the JAX 2.1 pipeline's image conversion keep its float input
    beside the PIL images it returns."""
    import kandinsky2_tpu.pipelines.kandinsky2_1 as jpipe_mod

    to_pil = jpipe_mod.process_images

    def process_images(batch):
        out = JaxImages(to_pil(batch))
        out.floats = np.asarray(batch, np.float32)
        return out

    monkeypatch.setattr(jpipe_mod, "process_images", process_images)


def inject_prior_noise(monkeypatch, pipe, seed: int, clip_dim: int):
    """Fill the noise that a pipeline's ``generate_clip_emb`` would draw
    (x_T, and the per-step noise of an ancestral ladder) from a numpy seed
    wherever the caller passes none, so both frameworks' staged entry
    points draw the same.  Every call takes its draws in the same order."""
    rng = np.random.RandomState(seed)
    inner = pipe.generate_clip_emb

    def generate_clip_emb(prompt, batch_size=1, prior_cf_scale=4, prior_steps="25",
                          negative_prior_prompt="", noise=None, noise_seq=None,
                          **kw):
        ps = str(prior_steps)
        x_T = rng.randn(batch_size, clip_dim).astype(np.float32)
        seq = (rng.randn(int(ps), batch_size, clip_dim).astype(np.float32)
               if ps.isdigit() else None)
        return inner(prompt, batch_size=batch_size, prior_cf_scale=prior_cf_scale,
                     prior_steps=prior_steps,
                     negative_prior_prompt=negative_prior_prompt,
                     noise=x_T if noise is None else noise,
                     noise_seq=seq if noise_seq is None else noise_seq, **kw)

    monkeypatch.setattr(pipe, "generate_clip_emb", generate_clip_emb)


def inject_decoder_noise(monkeypatch, pipe, seed: int):
    """Fill the x_T that a pipeline's ``generate_img`` would draw from a
    numpy seed wherever the caller passes none."""
    rng = np.random.RandomState(seed)
    inner = pipe.generate_img

    def generate_img(*args, noise=None, h=512, w=512, batch_size=1, **kw):
        if noise is None:
            noise = rng.randn(batch_size, (h + 63) // 64 * 8, (w + 63) // 64 * 8,
                              4).astype(np.float32)
        return inner(*args, noise=noise, h=h, w=w, batch_size=batch_size, **kw)

    monkeypatch.setattr(pipe, "generate_img", generate_img)


# --- the 2.2 pipeline in both frameworks --------------------------------------

# tests/test_pipeline22.py's TINY overrides
TINY22 = dict(
    image_encoder=dict(image_size=28, patch_size=14, hidden=32, layers=2, heads=4,
                       intermediate=64, projection_dim=32),
    text_encoder=dict(vocab_size=64, context_length=8, hidden=32, layers=2, heads=4,
                      intermediate=64, projection_dim=32, eot_token_id=63),
    prior=dict(num_attention_heads=4, attention_head_dim=16, num_layers=2,
               embedding_dim=32, num_embeddings=8),
    unet=dict(block_out_channels=(32, 64), layers_per_block=1, attention_head_dim=32,
              cross_attention_dim=32, encoder_hid_dim=32, num_image_tokens=2),
    movq=dict(z_channels=4, embed_dim=4, n_embed=32, ch=32, ch_mult=(1, 1, 1, 2),
              num_res_blocks=1, attn_resolutions=(8,), resolution=64),
)


def tiny22(head_channels=32):
    """TINY22, or its variant with 64-wide UNet heads (the width K3 takes)."""
    if head_channels == 32:
        return TINY22
    unet = dict(TINY22["unet"], block_out_channels=(64, 128), attention_head_dim=64)
    return dict(TINY22, unet=unet)


def parity_pipelines22(task_type="text2img", seed=21, head_channels=32,
                       jax_dtype=None, torch_dtype=torch.float32, unet_out_scale=1.0):
    """(JAX Kandinsky2_2, port Kandinsky2_2 on the CPU, params) at
    ``tiny22(head_channels)`` with the same numpy-seeded parameters and the
    port's 2.2 stand-in tokenizer (the JAX test's ``StubBPE``); the MoVQ's
    output conv scaled by 0.01 as in ``parity_pipelines``, the UNet's by
    ``unet_out_scale``."""
    import jax.numpy as jnp

    from kandinsky2_tpu.pipelines.kandinsky2_2 import Kandinsky2_2 as J22
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_2 as T22
    from kandinsky2_tpu_torch.utils import stub_tokenizer22

    ov = tiny22(head_channels)
    tok = stub_tokenizer22(ov["text_encoder"]["vocab_size"])
    jp = J22(task_type=task_type, tokenizer=tok, dtype=jax_dtype or jnp.float32,
             overrides=ov)
    params = numpy_params(
        jax.eval_shape(jp.init_random_params, jax.random.PRNGKey(0)), seed)
    # clip_std drawn around 1, as the port's init_random_params draws it
    params["prior"]["clip_std"] = np.abs(1.0 + params["prior"]["clip_std"])
    conv_out = params["movq"]["decoder"]["conv_out"]
    conv_out["kernel"] = conv_out["kernel"] * np.float32(0.01)
    unet_out = params["unet"]["conv_out"]
    unet_out["kernel"] = unet_out["kernel"] * np.float32(unet_out_scale)
    jp.params = jax.tree_util.tree_map(jnp.asarray, params)
    tp = T22(task_type=task_type, tokenizer=tok, dtype=torch_dtype, overrides=ov,
             device="cpu")
    tp.load_jax_params(params)
    return jp, tp, params


def capture_jax_floats22(monkeypatch):
    """``capture_jax_floats`` for the JAX 2.2 pipeline."""
    import kandinsky2_tpu.pipelines.kandinsky2_2 as jpipe22

    to_pil = jpipe22.process_images

    def process_images(batch):
        out = JaxImages(to_pil(batch))
        out.floats = np.asarray(batch, np.float32)
        return out

    monkeypatch.setattr(jpipe22, "process_images", process_images)


def inject_prior22(monkeypatch, pipe, seed: int):
    """Fill the x_T (and, on the ddpm ladder, the per-step noise) that a 2.2
    pipeline's ``run_prior`` would draw from a numpy seed wherever the
    caller passes none, the same draws in the same order on both sides."""
    rng = np.random.RandomState(seed)
    inner = pipe.run_prior
    D = pipe.prior.embedding_dim

    def run_prior(prompt, batch_size=1, prior_steps=25, guidance_scale=4,
                  negative_prompt="", sampler="ddpm", noise=None, noise_seq=None, **kw):
        x_T = rng.randn(batch_size, D).astype(np.float32)
        seq = (rng.randn(prior_steps, batch_size, D).astype(np.float32)
               if sampler == "ddpm" else None)
        return inner(prompt, batch_size, prior_steps, guidance_scale, negative_prompt,
                     sampler=sampler, noise=x_T if noise is None else noise,
                     noise_seq=seq if noise_seq is None else noise_seq, **kw)

    monkeypatch.setattr(pipe, "run_prior", run_prior)


def inject_decoder22(monkeypatch, pipe, seed: int, to_tensor=False):
    """Fill the x_T and the ddpm per-step noise that a 2.2 pipeline's
    ``_decode_loop`` would draw from a numpy seed wherever the caller passes
    none (``to_tensor`` for the port, whose loop takes tensors)."""
    rng = np.random.RandomState(seed)
    inner = pipe._decode_loop

    def _decode_loop(image_embeds, batch_size, steps, guidance, h, w, x_T=None,
                     ladder=None, sampler="ddpm", noise_seq=None, **kw):
        if x_T is None:
            x_T = rng.randn(batch_size, h // 8, w // 8, 4).astype(np.float32)
            if to_tensor:
                x_T = torch.from_numpy(x_T)
        n = steps if ladder is None else len(ladder)
        if noise_seq is None and sampler == "ddpm":
            noise_seq = rng.randn(n, *x_T.shape).astype(np.float32)
        return inner(image_embeds, batch_size, steps, guidance, h, w, x_T=x_T,
                     ladder=ladder, sampler=sampler, noise_seq=noise_seq, **kw)

    monkeypatch.setattr(pipe, "_decode_loop", _decode_loop)


def flash_route(monkeypatch):
    """Send every unmasked fp32 attention of the port's 2.2 UNet down K3's
    route (the kernel's plain version on the CPU), which the routing rule
    keeps for bf16; returns the list of the routed calls' (q, k) shapes."""
    from kandinsky2_tpu_torch.ops import attention as tattn

    calls = []
    plain = tattn.flash_attention

    def counted(q, k, v):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return plain(q, k, v)

    monkeypatch.setattr(tattn, "use_flash_kernel", lambda q, k, v: True)
    monkeypatch.setattr(tattn, "flash_attention", counted)
    return calls


# --- the 2.0 pipeline in both frameworks --------------------------------------


def tiny_config20(head_channels=16):
    """``tests/test_pipeline20.py``'s ``tiny_config20`` (the port's
    ``small_config20``), or its variant with 64-wide UNet heads."""
    return torch_configs.small_config20(head_channels)


def parity_pipelines20(task_type="text2img", seed=20, head_channels=16,
                       jax_dtype=None, torch_dtype=torch.float32):
    """(JAX Kandinsky2, port Kandinsky2 on the CPU, params) at
    ``tiny_config20(head_channels)`` with the same numpy-seeded parameters
    and the port's stand-in tokenizer for both streams.  The KL-VAE's
    output conv is scaled by 0.1, which puts the random weights' image at
    |x| ~ 2, inside the absolute image tolerance's range."""
    import jax.numpy as jnp

    from kandinsky2_tpu.pipelines.kandinsky2_0 import Kandinsky2 as J20
    from kandinsky2_tpu_torch.pipelines import Kandinsky2 as T20
    from kandinsky2_tpu_torch.utils import stub_tokenizers

    tok, _ = stub_tokenizers(64)
    kw = dict(config=tiny_config20(head_channels), tokenizer1=tok, tokenizer2=tok,
              task_type=task_type)
    jp = J20(dtype=jax_dtype or jnp.float32, **kw)
    params = numpy_params(
        jax.eval_shape(jp.init_random_params, jax.random.PRNGKey(0)), seed)
    conv_out = params["image_encoder"]["decoder"]["conv_out"]
    conv_out["kernel"] = conv_out["kernel"] * np.float32(0.1)
    jp.params = jax.tree_util.tree_map(jnp.asarray, params)
    tp = T20(dtype=torch_dtype, device="cpu", **kw)
    tp.load_jax_params(params)
    return jp, tp, params


def capture_jax_floats20(monkeypatch):
    """``capture_jax_floats`` for the JAX 2.0 pipeline."""
    import kandinsky2_tpu.pipelines.kandinsky2_0 as jpipe20

    to_pil = jpipe20.process_images

    def process_images(batch):
        out = JaxImages(to_pil(batch))
        out.floats = np.asarray(batch, np.float32)
        return out

    monkeypatch.setattr(jpipe20, "process_images", process_images)


# --- pairs built once a process ------------------------------------------------


@functools.lru_cache(maxsize=None)
def shared_pair(version: str):
    """``parity_pipelines()``, ``parity_pipelines22()`` or
    ``parity_pipelines20()`` at their defaults by ``version``, built once a
    process, for tests that leave the pipelines and their params as they
    found them (or restore them)."""
    return {"2.1": parity_pipelines, "2.2": parity_pipelines22,
            "2.0": parity_pipelines20}[version]()
