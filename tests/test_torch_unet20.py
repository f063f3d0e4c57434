"""The port's 2.0 UNets (``Text2ImUNet20``, ``InpaintText2ImUNet20``)
against the JAX package's, built by both factories from
``tiny_config20``'s model config, every parameter drawn from a numpy seed
and loaded into both through the bridge, in fp32 at 1e-4:
``encode_conditioning`` (xf_proj, and the 77-token XLM-R + mT5 stream
concatenation xf_out), ``denoise``, and the forward, with the pooled
XLM-R embedding projected ("from_model") or attention-pooled from its
tokens; the inpainting variant on x ⊕ image·mask ⊕ mask.  The 64-wide-head
variant routes its attention down K3's path (the kernel's plain version on
the CPU)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kandinsky2_tpu import configs as jcfg
from kandinsky2_tpu_torch import configs as tcfg
from kandinsky2_tpu_torch.models import unet as tunet
from kandinsky2_tpu_torch.weights.from_jax import load_jax_params
from test_torch_common import (
    MODULE_TOL,
    assert_close,
    flash_route,
    numpy_params,
    tiny_config20,
)

T = torch.from_numpy


def _inputs(mc, seed, L1=7):
    rng = np.random.RandomState(seed)
    f = lambda *shape: rng.randn(*shape).astype(np.float32)
    return dict(x=f(2, 8, 8, 4), ts=np.array([999.0, 421.0], np.float32),
                full1=f(2, L1, mc["text_encoder_in_dim1"]),
                pooled1=f(2, mc["text_encoder_in_dim2"]), full2=f(2, 9, 512),
                image=f(2, 8, 8, 4), mask=(rng.rand(2, 8, 8, 1) > 0.5).astype(np.float32))


@pytest.mark.parametrize("pooling_type,head", [("from_model", 16),
                                               ("attention", 16),
                                               ("from_model", 64)])
def test_text2im_unet20(monkeypatch, pooling_type, head):
    mc = dict(tiny_config20(head)["model_config"], pooling_type=pooling_type)
    if pooling_type == "attention":  # 8 heads over the pooled width
        mc["text_encoder_in_dim2"] = 32
    a = _inputs(mc, 1)
    jm = jcfg.create_model(**mc, dtype=jnp.float32)
    params = numpy_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), a["x"], a["ts"], full_emb1=a["full1"],
        pooled_emb1=a["pooled1"], full_emb2=a["full2"]), 2)
    xf_proj, xf_out = jax.jit(partial(jm.apply, method=type(jm).encode_conditioning))(
        params, a["full1"], a["pooled1"], a["full2"], None)
    want = jax.jit(partial(jm.apply, method=type(jm).denoise))(
        params, a["x"], a["ts"], xf_proj, xf_out)

    tm = tcfg.create_model(**mc, dtype=torch.float32)
    assert type(tm) is tunet.Text2ImUNet20
    load_jax_params(tm, params["params"])
    if head == 64:
        calls = flash_route(monkeypatch)
    with torch.no_grad():
        t_proj, t_out = tm.encode_conditioning(T(a["full1"]), T(a["pooled1"]),
                                               T(a["full2"]))
        got = tm.denoise(T(a["x"]), T(a["ts"]), t_proj, t_out)
        fwd = tm(T(a["x"]), T(a["ts"]), T(a["full1"]), T(a["pooled1"]), T(a["full2"]))
    assert t_out.shape == (2, 7 + 9, mc["model_dim"])
    assert_close(t_proj, xf_proj, MODULE_TOL, "xf_proj")
    assert_close(t_out, xf_out, MODULE_TOL, "xf_out")
    assert_close(got, want, MODULE_TOL, "denoise")
    assert_close(fwd, want, MODULE_TOL, "forward")
    assert np.abs(np.asarray(want)).max() > 1e-2  # a live output head
    if head == 64:  # K3's route, S = T + 7 + 9 tokens
        assert calls and all(k[1] == q[1] + 16 for q, k in calls)


def test_inpaint_text2im_unet20():
    mc = dict(tiny_config20()["model_config"], inpainting=True)
    a = _inputs(mc, 3)
    jm = jcfg.create_model(**mc, dtype=jnp.float32)
    params = numpy_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), a["x"], a["ts"], full_emb1=a["full1"],
        pooled_emb1=a["pooled1"], full_emb2=a["full2"], inpaint_image=a["image"],
        inpaint_mask=a["mask"]), 4)
    want = jax.jit(jm.apply)(params, a["x"], a["ts"], a["full1"], a["pooled1"],
                             a["full2"], None, a["image"], a["mask"])
    tm = tcfg.create_model(**mc, dtype=torch.float32)
    assert type(tm) is tunet.InpaintText2ImUNet20
    assert tm.input_blocks[0][0].weight.shape[1] == 9
    load_jax_params(tm, params["params"])
    with torch.no_grad():
        got = tm(T(a["x"]), T(a["ts"]), T(a["full1"]), T(a["pooled1"]), T(a["full2"]),
                 None, T(a["image"]), T(a["mask"]))
    assert_close(got, want, MODULE_TOL, "InpaintText2ImUNet20")


def test_create_model_versions():
    """The factory's default version is 2.0, as the JAX package's; 2.1
    takes attention pooling as JAX's does; anything else raises."""
    mc = tiny_config20()["model_config"]
    assert "version" not in mc
    assert type(tcfg.create_model(**mc, device="meta")) is tunet.Text2ImUNet20
    m21 = tcfg.create_model(**dict(mc, version="2.1", pooling_type="attention"),
                            device="meta")
    assert type(m21) is tunet.Text2ImUNet21
    assert isinstance(m21.proj_n, tunet.AttentionPooling)
    with pytest.raises(ValueError):
        tcfg.create_model(**dict(mc, version="3.0"), device="meta")
