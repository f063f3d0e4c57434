"""Full-size structure check of the port: the five 2.1 slice models built at
the full ``CONFIG_2_1`` width on the meta device (nothing allocated) against
the JAX trees from ``jax.eval_shape`` of ``init``.  The bridge must map every
JAX leaf onto a port key of the transposed shape, and fill every port key:
for the MoVQ that includes the encoder, ``quant_conv`` and ``quantize``;
the inpainting UNet (``InpaintText2ImUNet21``) is checked beside them.  The
same for the five 2.2 models at the vendored published configuration
(``weights/configs22.pipeline_overrides``), with their parameter counts,
and the 2.2 inpainting and ControlNet UNets; and the four 2.0 models at
``CONFIG_2_0`` with the 2.0 inpainting UNet."""

import math

import jax
import jax.numpy as jnp
import pytest

import kandinsky2_tpu.pipelines.kandinsky2_1 as jpipe_mod
from kandinsky2_tpu_torch.pipelines import Kandinsky2_1 as TorchK21
from kandinsky2_tpu_torch.weights.from_jax import plan


@pytest.fixture(scope="module")
def pipes():
    jp = jpipe_mod.Kandinsky2_1(dtype=jnp.float32)
    B = 1
    hp = jp.config["prior"]["params"]["model"]["hparams"]
    mc = jp.config["model_config"]
    z = jnp.zeros
    inits = {
        "prior": lambda k: jp.prior.init(
            k, z((B, hp["clip_dim"])), z((B,)), z((B, hp["clip_dim"])),
            z((B, hp["text_ctx"], hp["clip_xf_width"])),
            jnp.ones((B, hp["text_ctx"]), bool)),
        "clip_text": lambda k: jp.clip_text.init(k, z((B, 77), jnp.int32)),
        "clip_vision": lambda k: jp.clip_vision.init(k, z((B, 224, 224, 3))),
        "text_encoder": lambda k: jp.text_encoder.init(
            k, z((B, 8), jnp.int32), jnp.ones((B, 8), jnp.int32)),
        "unet": lambda k: jp.unet.init(
            k, z((B, 8, 8, 4)), z((B,)),
            full_emb=z((B, 77, mc["text_encoder_in_dim1"])),
            pooled_emb=z((B, mc["text_encoder_in_dim2"])),
            image_emb=z((B, mc["image_encoder_in_dim"]))),
        "movq": lambda k: jp.movq.init(k, z((B, 64, 64, 3))),
        "unet_inpaint": lambda k: jpipe_mod.Kandinsky2_1(
            dtype=jnp.float32, task_type="inpainting").unet.init(
            k, z((B, 8, 8, 4)), z((B,)),
            full_emb=z((B, 77, mc["text_encoder_in_dim1"])),
            pooled_emb=z((B, mc["text_encoder_in_dim2"])),
            image_emb=z((B, mc["image_encoder_in_dim"])),
            inpaint_image=z((B, 8, 8, 4)), inpaint_mask=z((B, 8, 8, 1))),
    }
    models = TorchK21(device="meta").models()
    models["unet_inpaint"] = TorchK21(device="meta", task_type="inpainting").unet
    return inits, models


@pytest.mark.parametrize("name", ["unet", "movq", "prior", "clip_text",
                                  "clip_vision", "text_encoder", "unet_inpaint"])
def test_fullsize_bridge_covers_model(pipes, name):
    inits, models = pipes
    shapes = jax.eval_shape(inits[name], jax.random.PRNGKey(0))["params"]
    target = {k: tuple(v.shape) for k, v in models[name].state_dict().items()}
    mapping = plan(shapes, target)
    assert set(mapping) == set(target)
    n_params = sum(int(jnp.prod(jnp.array(s))) for s in target.values())
    if name.startswith("unet"):
        assert 1.2e9 < n_params < 1.25e9  # the 1.22B decoder UNet
    if name == "unet_inpaint":  # x ⊕ image·mask ⊕ mask: 2 * 4 + 1 channels
        assert target["input_blocks.0.0.weight"] == (384, 9, 3, 3)
    if name == "movq":
        for prefix in ("encoder.", "quant_conv.", "quantize.", "decoder."):
            assert any(k.startswith(prefix) for k in mapping), prefix
        assert target["quantize.embedding.weight"] == (16384, 4)


# --- Kandinsky 2.2 at the published configuration -------------------------------

# parameters of each 2.2 model at the vendored configuration
PARAMS22 = {"unet": 1_309_009_800, "movq": 67_832_495, "prior": 1_026_225_920,
            "text_encoder": 694_659_840, "image_encoder": 1_844_907_264}


@pytest.fixture(scope="module")
def pipes22():
    from kandinsky2_tpu.pipelines.kandinsky2_2 import Kandinsky2_2 as J22
    from kandinsky2_tpu.weights import configs22 as jcfg
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_2 as T22
    from kandinsky2_tpu_torch.weights import configs22 as tcfg

    inits, models = {}, {}
    for task in ("text2img", "inpainting", "controlnet"):
        jp = J22(task_type=task, dtype=jnp.float32,
                 overrides=jcfg.pipeline_overrides(None, None, task))
        tp = T22(task_type=task, overrides=tcfg.pipeline_overrides(task_type=task),
                 device="meta")
        z = jnp.zeros
        hint = {"hint": z((1, 64, 64, 3))} if task == "controlnet" else {}
        x_ch = jp.unet.in_channels - (4 if task == "controlnet" else 0)
        unet_init = (lambda jp, x_ch, hint: lambda k: jp.unet.init(
            k, z((1, 8, 8, x_ch)), z((1,)), z((1, jp.unet.encoder_hid_dim)), **hint))(
            jp, x_ch, hint)
        if task != "text2img":
            inits["unet_" + task] = unet_init
            models["unet_" + task] = tp.unet
            continue
        D, ctx = jp.prior.embedding_dim, jp.text_encoder.context_length
        inits.update({
            "unet": unet_init,
            "movq": lambda k: jp.movq.init(k, z((1, 64, 64, 3))),
            "prior": lambda k: jp.prior.init(
                k, z((1, D)), z((1,)), z((1, D)),
                z((1, jp.prior.num_embeddings, jp.text_encoder.hidden)),
                jnp.ones((1, jp.prior.num_embeddings), bool)),
            "text_encoder": lambda k: jp.text_encoder.init(k, z((1, ctx), jnp.int32)),
            "image_encoder": lambda k: jp.image_encoder.init(k, z((1, 224, 224, 3))),
        })
        models.update(tp.models())
    return inits, models


@pytest.mark.parametrize("name", list(PARAMS22) + ["unet_inpainting", "unet_controlnet"])
def test_fullsize_bridge_covers_model22(pipes22, name):
    inits, models = pipes22
    shapes = jax.eval_shape(inits[name], jax.random.PRNGKey(0))["params"]
    target = {k: tuple(v.shape) for k, v in models[name].state_dict().items()}
    mapping = plan(shapes, target)
    assert set(mapping) == set(target)
    n_params = sum(math.prod(s) for s in target.values())
    if name in PARAMS22:
        assert n_params == PARAMS22[name], n_params
    if name == "unet_inpainting":  # latent 4 + masked latent 4 + mask 1
        assert target["conv_in.weight"] == (384, 9, 3, 3)
    if name == "unet_controlnet":  # latent 4 + the hint stack's 4
        assert target["conv_in.weight"] == (384, 8, 3, 3)
        assert target["add_embedding.input_hint_block.14.weight"] == (4, 256, 3, 3)
    if name == "unet":
        assert target["mid_block.attentions.0.add_k_proj.weight"] == (1536, 768)
        assert target["encoder_hid_proj.image_embeds.weight"] == (7680, 1280)


# --- Kandinsky 2.0 at CONFIG_2_0 -------------------------------------------------

# parameters of each 2.0 model at CONFIG_2_0 (XLM-R large 1024 -> 640, the
# mT5-small encoder, Text2ImUNet20, the KL-VAE)
PARAMS20 = {"text_encoder1": 559_496_832, "text_encoder2": 146_940_608,
            "unet": 1_223_352_584, "image_encoder": 83_653_863,
            "unet_inpainting": 1_223_369_864}


@pytest.fixture(scope="module")
def pipes20():
    from kandinsky2_tpu.pipelines.kandinsky2_0 import Kandinsky2 as J20
    from kandinsky2_tpu_torch.pipelines import Kandinsky2 as T20

    jp = J20(dtype=jnp.float32)
    mc = jp.config["model_config"]
    z = jnp.zeros
    cond = lambda: dict(full_emb1=z((1, 77, mc["text_encoder_in_dim1"])),
                        pooled_emb1=z((1, mc["text_encoder_in_dim2"])),
                        full_emb2=z((1, 77, 512)))
    ids = lambda L: (z((1, L), jnp.int32), jnp.ones((1, L), jnp.int32))
    inits = {
        "text_encoder1": lambda k: jp.text_encoder1.init(k, *ids(8)),
        "text_encoder2": lambda k: jp.text_encoder2.init(k, *ids(8)),
        "unet": lambda k: jp.unet.init(k, z((1, 8, 8, 4)), z((1,)), **cond()),
        "image_encoder": lambda k: jp.image_encoder.init(k, z((1, 64, 64, 3))),
        "unet_inpainting": lambda k: J20(dtype=jnp.float32, task_type="inpainting")
        .unet.init(k, z((1, 8, 8, 4)), z((1,)), inpaint_image=z((1, 8, 8, 4)),
                   inpaint_mask=z((1, 8, 8, 1)), **cond()),
    }
    models = T20(device="meta").models()
    models["unet_inpainting"] = T20(device="meta", task_type="inpainting").unet
    return inits, models


@pytest.mark.parametrize("name", list(PARAMS20))
def test_fullsize_bridge_covers_model20(pipes20, name):
    inits, models = pipes20
    shapes = jax.eval_shape(inits[name], jax.random.PRNGKey(0))["params"]
    target = {k: tuple(v.shape) for k, v in models[name].state_dict().items()}
    mapping = plan(shapes, target)
    assert set(mapping) == set(target)
    assert sum(math.prod(s) for s in target.values()) == PARAMS20[name]
    if name == "text_encoder2":  # mT5-small: the 250112-token table, 8 blocks
        assert target["shared.weight"] == (250112, 512)
        assert target[
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] \
            == (32, 6)
    if name == "unet":  # the AttentionPooling of the mT5 tokens, the 1x1 convs
        assert target["proj2.q_linear.weight"] == (512, 512)
        assert target["to_model_dim2.weight"] == (768, 512)
    if name == "unet_inpainting":
        assert target["input_blocks.0.0.weight"] == (384, 9, 3, 3)
    if name == "image_encoder":
        assert target["quant_conv.weight"] == (8, 8)
        assert target["encoder.conv_out.weight"] == (8, 512, 3, 3)
