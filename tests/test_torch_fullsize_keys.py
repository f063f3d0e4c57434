"""Full-size structure check of the port: the five 2.1 slice models built at
the full ``CONFIG_2_1`` width on the meta device (nothing allocated) against
the JAX trees from ``jax.eval_shape`` of ``init``.  The bridge must map every
JAX leaf of the slice's submodules onto a port key of the transposed shape,
and fill every port key."""

import jax
import jax.numpy as jnp
import pytest

import kandinsky2_tpu.pipelines.kandinsky2_1 as jpipe_mod
from kandinsky2_tpu_torch.pipelines import Kandinsky2_1 as TorchK21
from kandinsky2_tpu_torch.pipelines.kandinsky2_1 import MOVQ_UNPORTED
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
    }
    return inits, TorchK21(device="meta").models()


@pytest.mark.parametrize("name", ["unet", "movq", "prior", "clip_text",
                                  "clip_vision", "text_encoder"])
def test_fullsize_bridge_covers_model(pipes, name):
    inits, models = pipes
    shapes = jax.eval_shape(inits[name], jax.random.PRNGKey(0))["params"]
    target = {k: tuple(v.shape) for k, v in models[name].state_dict().items()}
    skip = MOVQ_UNPORTED if name == "movq" else ()
    mapping = plan(shapes, target, skip_prefixes=skip)
    assert set(mapping) == set(target)
    n_params = sum(int(jnp.prod(jnp.array(s))) for s in target.values())
    if name == "unet":
        assert 1.2e9 < n_params < 1.25e9  # the 1.22B decoder UNet
