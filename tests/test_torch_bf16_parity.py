"""The port in bf16 against the JAX package in bf16, on the CPU, at
``small_config(head_channels=64)`` (the head width the flash kernel
takes) with the same parameters through the bridge: each model's forward
on the same inputs, and the 10-step text2img path with the same injected
noise.  Each relative L2 is printed and pinned at about twice its value
measured on the CPU (the ``BF16_TOL`` comments give that value).

Both packages keep fp32 parameters (the port's bf16 layers hold them as
bf16, the JAX layers cast fp32 to bf16 at each use: the same rounding),
bf16 activations, and fp32 norm statistics and softmax.  The gap that
remains comes from two departures:

* attention: where the flash kernel runs (bf16, d in {64, 512}), the port
  computes the logits from unscaled q and k in fp32 (the kernel's plain
  version on the CPU) with one 1/√d scale, while JAX's ``_xla_attention``
  keeps them in bf16 after pre-scaling q and k by d^-1/4 each (the UNet's
  and the MoVQ's attention; ROADMAP "Deliberate departures").  It is the
  smaller part: with ``ops.attention.use_flash_kernel`` patched to route
  every call to the reference semantics instead, the UNet's gap was
  1.76e-2 (1.70e-2 routed to the kernel), the MoVQ decoder's 1.9e-3
  (1.9e-3), the encoder's 1.6e-2 (1.7e-2) and the text2img path's 2.06e-1
  (1.74e-1), measured on the CPU;
* bf16 rounding of two libraries' matmuls, convolutions and elementwise
  chains, which round at different points and sum in different orders.
  It compounds over the 15 CFG-4 model calls of the path: the port in
  bf16 is 9.3e-2 from its own fp32 run there, and JAX in bf16 1.77e-1
  from its own (the two fp32 runs agree to 3.9e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import parity_pipelines

# relative L2 of the port against JAX, both bf16: about twice the value
# measured on the CPU, which follows each entry
BF16_TOL = {
    "unet": 3.4e-2,  # 1.70e-2
    "movq.decode": 4e-3,  # 1.9e-3
    "movq.encode": 3.5e-2,  # 1.7e-2
    "prior": 2.1e-2,  # 1.04e-2
    "clip_text": 2.4e-2,  # 1.19e-2
    "clip_vision": 1.7e-2,  # 8.4e-3
    "text_encoder": 1.7e-2,  # 8.6e-3 (full), 4.7e-3 (pooled)
    "text2img": 0.35,  # 1.74e-1
}


@pytest.fixture(scope="module")
def pipes():
    jp, tp, _ = parity_pipelines(head_channels=64, jax_dtype=jnp.bfloat16,
                                 torch_dtype=torch.bfloat16)
    return jp, tp


def _rel_l2(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(mc):
    rng = np.random.RandomState(5)
    f = lambda *shape: rng.randn(*shape).astype(np.float32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 6:] = 0
    prior_mask = np.ones((2, 8), bool)
    prior_mask[1, 4:] = False
    return {
        "unet": (f(2, 8, 8, 4), np.array([981.0, 501.0], np.float32),
                 f(2, 38, mc["text_encoder_in_dim1"]), f(2, mc["text_encoder_in_dim2"]),
                 f(2, mc["image_encoder_in_dim"])),
        "movq.decode": (f(1, 8, 8, 4),),
        "movq.encode": (np.tanh(f(1, 64, 64, 3)),),
        "prior": (f(2, 64), np.array([3.0, 1.0], np.float32), f(2, 64), f(2, 8, 64),
                  prior_mask),
        "clip_text": (rng.randint(1, 200, (2, 8)).astype(np.int32),),
        "clip_vision": (f(1, 28, 28, 3),),
        "text_encoder": (rng.randint(2, 200, (2, 12)).astype(np.int32), mask),
    }


def _jax_call(jp, name, args):
    model, method = {"unet": ("unet", None), "movq.decode": ("movq", "decode"),
                     "movq.encode": ("movq", "encode")}.get(name, (name, None))
    module = getattr(jp, model)
    kw = {} if method is None else {"method": getattr(type(module), method)}
    if name == "unet":
        x, t, full, pooled, image = args
        return module.apply({"params": jp.params["unet"]}, x, t, full_emb=full,
                            pooled_emb=pooled, image_emb=image)
    if name == "prior":
        x, t, emb, enc, mask = args
        return module.apply({"params": jp.params["prior"]}, x, t, text_emb=emb,
                            text_enc=enc, mask=mask)
    return module.apply({"params": jp.params[model]}, *args, **kw)


def _torch_call(tp, name, args):
    T = torch.from_numpy
    args = [T(np.asarray(a)) for a in args]
    if name in ("clip_text", "text_encoder"):
        args = [args[0].long()] + args[1:]
    with torch.inference_mode():
        if name.startswith("movq."):
            return getattr(tp.movq, name[5:])(*args)
        return tp.models()[name](*args)


@pytest.mark.parametrize("name", [n for n in BF16_TOL if n != "text2img"])
def test_model_forward_bf16_matches_jax(pipes, name):
    jp, tp = pipes
    args = _inputs(tp.config["model_config"])[name]
    want = jax.jit(lambda *a: _jax_call(jp, name, a))(*args)
    got = _torch_call(tp, name, args)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for k, (g, w) in enumerate(zip(got, want)):
        rel = _rel_l2(g.float().numpy(), np.asarray(w, np.float32))
        print(f"bf16 port vs bf16 JAX: {name}[{k}] rel_l2 {rel:.3e} "
              f"(tol {BF16_TOL[name]})")
        assert rel <= BF16_TOL[name], f"{name}[{k}]: {rel:.3e}"


def test_text2img_bf16_matches_jax(pipes, monkeypatch):
    import kandinsky2_tpu.pipelines.kandinsky2_1 as jpipe_mod

    jp, tp = pipes
    monkeypatch.setattr(jpipe_mod, "process_images", np.asarray)
    rng = np.random.RandomState(4)
    kw = dict(num_steps=10, guidance_scale=4, prior_cf_scale=4, prior_steps="5",
              h=64, w=64, noise=rng.randn(1, 8, 8, 4).astype(np.float32),
              prior_noise=rng.randn(1, 64).astype(np.float32),
              prior_noise_seq=rng.randn(5, 1, 64).astype(np.float32))
    want = np.asarray(jp.generate_text2img("red sand dunes under a violet sky", **kw))
    got = tp.generate_text2img("red sand dunes under a violet sky", output="float",
                               **kw)
    rel = _rel_l2(got, want)
    print(f"bf16 port vs bf16 JAX: text2img 10 DDIM steps rel_l2 {rel:.3e} "
          f"(tol {BF16_TOL['text2img']})")
    assert np.std(got) > 1e-3
    assert rel <= BF16_TOL["text2img"], f"text2img: {rel:.3e}"


# --- Kandinsky 2.2 ------------------------------------------------------------

# relative L2 of the port against JAX, both bf16, at test_pipeline22.py's
# TINY shape with 64-wide UNet heads: about twice the value measured on the
# CPU, which follows each entry
BF16_TOL22 = {
    "unet22": 3.5e-2,  # 1.735e-2
    "text2img22": 7.5e-2,  # 3.744e-2
}


@pytest.fixture(scope="module")
def pipes22():
    from test_torch_common import parity_pipelines22

    jp, tp, _ = parity_pipelines22(head_channels=64, jax_dtype=jnp.bfloat16,
                                   torch_dtype=torch.bfloat16)
    return jp, tp


def test_unet22_forward_bf16_matches_jax(pipes22):
    """The 2.2 UNet, its added-KV attention on K3's route (the kernel's plain
    version on the CPU in bf16)."""
    jp, tp = pipes22
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([981.0, 301.0], np.float32)
    emb = rng.randn(2, jp.unet.encoder_hid_dim).astype(np.float32)
    want = jax.jit(lambda p, *a: jp.unet.apply({"params": p}, *a))(
        jp.params["unet"], x, t, emb)
    with torch.inference_mode():
        got = tp.unet(*(torch.from_numpy(a) for a in (x, t, emb)))
    rel = _rel_l2(got.float().numpy(), np.asarray(want, np.float32))
    print(f"bf16 port vs bf16 JAX: unet22 rel_l2 {rel:.3e} (tol {BF16_TOL22['unet22']})")
    assert rel <= BF16_TOL22["unet22"], f"unet22: {rel:.3e}"


def test_text2img22_bf16_matches_jax(pipes22, monkeypatch):
    """The small 2.2 text2img path: 5 prior and 10 decoder DDPM steps under
    CFG 4, every noise injected."""
    import kandinsky2_tpu.pipelines.kandinsky2_2 as jpipe22

    jp, tp = pipes22
    monkeypatch.setattr(jpipe22, "process_images", np.asarray)
    rng = np.random.RandomState(7)
    D = jp.prior.embedding_dim
    kw = dict(decoder_steps=10, prior_steps=5, h=64, w=64,
              noise=rng.randn(1, 8, 8, 4).astype(np.float32),
              noise_seq=rng.randn(10, 1, 8, 8, 4).astype(np.float32),
              prior_noise=rng.randn(1, D).astype(np.float32),
              prior_noise_seq=rng.randn(5, 1, D).astype(np.float32))
    want = np.asarray(jp.generate_text2img("red sand dunes under a violet sky", **kw))
    got = tp.generate_text2img("red sand dunes under a violet sky", output="float", **kw)
    rel = _rel_l2(got, want)
    print(f"bf16 port vs bf16 JAX: 2.2 text2img 10 DDPM steps rel_l2 {rel:.3e} "
          f"(tol {BF16_TOL22['text2img22']})")
    assert np.std(got) > 1e-3
    assert rel <= BF16_TOL22["text2img22"], f"text2img22: {rel:.3e}"


# --- Kandinsky 2.0 ------------------------------------------------------------

# relative L2 of the port against JAX, both bf16, at tiny_config20 with
# 64-wide UNet heads: about twice the value measured on the CPU, which
# follows each entry
BF16_TOL20 = {
    "unet20": 3.0e-2,  # 1.524e-2
    "t5": 2.4e-2,  # 1.193e-2
    "vae_kl.decode": 1.5e-2,  # 7.644e-3
    "vae_kl.encode": 3.5e-2,  # 1.691e-2 (mean), 1.736e-2 (logvar)
}


@pytest.fixture(scope="module")
def pipes20():
    from test_torch_common import parity_pipelines20

    jp, tp, _ = parity_pipelines20(head_channels=64, jax_dtype=jnp.bfloat16,
                                   torch_dtype=torch.bfloat16)
    return jp, tp


def _inputs20(mc):
    rng = np.random.RandomState(8)
    f = lambda *shape: rng.randn(*shape).astype(np.float32)
    mask = np.ones((2, 77), np.int32)
    mask[1, 9:] = 0
    return {
        "unet20": (f(2, 8, 8, 4), np.array([981.0, 501.0], np.float32),
                   f(2, 38, mc["text_encoder_in_dim1"]), f(2, mc["text_encoder_in_dim2"]),
                   f(2, 77, 512)),
        "t5": (rng.randint(2, 64, (2, 77)).astype(np.int32), mask),
        "vae_kl.decode": (f(1, 8, 8, 4) / 0.0512 * 0.05,),
        "vae_kl.encode": (np.tanh(f(1, 64, 64, 3)),),
    }


@pytest.mark.parametrize("name", list(BF16_TOL20))
def test_model_forward20_bf16_matches_jax(pipes20, name):
    """The 2.0 UNet (its attention on K3's route: the kernel's plain version
    on the CPU in bf16), the mT5 tower, and the KL-VAE's decode and the
    mean and log-variance of its encode."""
    jp, tp = pipes20
    args = _inputs20(tp.config["model_config"])[name]
    model, method = {"unet20": ("unet", None), "t5": ("text_encoder2", None),
                     "vae_kl.decode": ("image_encoder", "decode"),
                     "vae_kl.encode": ("image_encoder", "encode")}[name]
    module = getattr(jp, model)
    kw = {} if method is None else {"method": getattr(type(module), method)}
    want = jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kw))(
        jp.params[model], *args)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    if name == "t5":
        targs[0] = targs[0].long()
    with torch.inference_mode():
        tm = getattr(tp, model)
        got = (tm if method is None else getattr(tm, method))(*targs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for k, (g, w) in enumerate(zip(got, want)):
        rel = _rel_l2(g.float().numpy(), np.asarray(w, np.float32))
        print(f"bf16 port vs bf16 JAX: {name}[{k}] rel_l2 {rel:.3e} "
              f"(tol {BF16_TOL20[name]})")
        assert rel <= BF16_TOL20[name], f"{name}[{k}]: {rel:.3e}"
