"""The port's micro-batching ``GenerationServer`` against the JAX package's:
the same request sequences over one recording pipeline (no model) give the
same pipeline calls, the same ``stats()`` and the same rejections; on the
port's small 2.1 pipeline coalesced requests get exactly the rows of a
direct batched call; LoRA hot-swap folds JAX's factors into the TINY
UNet22 as JAX's ``merge_lora`` does and restores the base bitwise; and the
2.1 and 2.2 pipelines draw from their own generator (``set_seed``), never
from torch's global one.

Every server thread a test starts is stopped in ``finally``, and every
``Future.result`` has its own timeout."""

import numpy as np
import pytest
import torch
from PIL import Image

from kandinsky2_tpu import serving as jserving
from kandinsky2_tpu_torch import serving as tserving

TIMEOUT = 60  # seconds for any one future


class Recorder:
    """A pipeline without a model: records each call's (entry point,
    prompts, images' tags, masks' first values, kwargs) and returns one
    tagged image a row.  ``weight`` (a callable) is read at each call."""

    def __init__(self, weight=None):
        self.calls = []
        self.weight = weight

    def _record(self, name, prompts, kw, images=None, masks=None):
        self.calls.append({
            "entry": name, "prompts": list(prompts),
            "images": None if images is None else [getattr(im, "tag", im.size)
                                                   for im in images],
            "masks": None if masks is None else [float(np.asarray(m)[0, 0])
                                                 for m in masks],
            "kwargs": dict(kw),
            "weight": None if self.weight is None else self.weight()})
        return [f"{name}:{p}" for p in prompts]

    def generate_text2img(self, prompts, **kw):
        return self._record("text2img", prompts, kw)

    def generate_img2img(self, prompts, images, **kw):
        return self._record("img2img", prompts, kw, images)

    def generate_inpainting(self, prompts, images, masks, **kw):
        return self._record("inpainting", prompts, kw, images, masks)


def tagged_image(tag, size=64):
    im = Image.new("RGB", (size, size))
    im.tag = tag
    return im


def mask(value, size=64):
    return np.full((size, size), value, np.float32)


def run_sequence(server, requests, restart_with=()):
    """Submit ``requests`` ((prompt, kwargs) pairs) before ``start()``, so
    that coalescing does not depend on thread timing; then, stopped, the
    ``restart_with`` requests the same way.  Returns each request's
    result."""
    results = []
    for batch in (requests, restart_with):
        if not batch:
            continue
        futs = [server.submit(p, **kw) for p, kw in batch]
        server.start()
        try:
            results += [f.result(timeout=TIMEOUT) for f in futs]
        finally:
            server.stop()
    return results


def sequence():
    kw = dict(h=64, w=64, num_steps=4)
    first = [(f"prompt {i}", dict(kw)) for i in range(5)]
    first += [("wide", dict(kw, w=128))]
    first += [(f"i2i {i}", dict(kw, task="img2img", image=tagged_image(f"im{i}"),
                                strength=0.5)) for i in range(3)]
    first += [(f"inp {i}", dict(kw, task="inpainting", image=tagged_image(f"mk{i}"),
                                image_mask=mask(i))) for i in range(2)]
    first += [("small image", dict(kw, task="img2img",
                                   image=tagged_image("s", 32), strength=0.5))]
    again = [(f"again {i}", dict(kw)) for i in range(3)]
    return first, again


@pytest.mark.parametrize("max_batch", [1, 3, 4])
def test_calls_and_stats_match_jax(max_batch):
    """The same requests, and a warmup over every task, make the same
    calls (prompts padded with the last, images and masks per row, kwargs,
    batch_size) and the same ``stats()`` in both servers."""
    got = {}
    for name, mod in (("jax", jserving), ("port", tserving)):
        pipe = Recorder()
        server = mod.GenerationServer(pipe, max_batch=max_batch)
        server.warmup([dict(h=64, w=64, num_steps=4),
                       dict(h=32, w=48, task="img2img"),
                       dict(h=32, w=32, task="inpainting")])
        warm = [(c["entry"], c["prompts"], c["kwargs"]) for c in pipe.calls]
        pipe.calls.clear()
        first, again = sequence()
        results = run_sequence(server, first, again)
        got[name] = (warm, pipe.calls, server.stats(), results)
    assert got["port"] == got["jax"]
    calls, stats = got["port"][1], got["port"][2]
    assert stats["requests"] == 15 and stats["errors"] == 0
    assert all(len(c["prompts"]) in server._buckets() for c in calls)


def test_nine_requests_coalesce_four_four_one():
    """The coalescing that phase 15 of chip_smoke.py expects: 9 requests
    → buckets 4, 4, 1 with no padding; then 3 more → one bucket-4 call
    with one padded row."""
    pipe = Recorder()
    server = tserving.GenerationServer(pipe, max_batch=4)
    kw = dict(h=64, w=64)
    run_sequence(server, [(f"p{i}", kw) for i in range(9)])
    s = server.stats()
    assert (s["requests"], s["batches"], s["padded"], s["coalesced"]) == (9, 3, 0, 8)
    assert [len(c["prompts"]) for c in pipe.calls] == [4, 4, 1]
    run_sequence(server, [(f"q{i}", kw) for i in range(3)])
    s = server.stats()
    assert (s["requests"], s["batches"], s["padded"]) == (12, 4, 1)
    assert pipe.calls[-1]["prompts"] == ["q0", "q1", "q2", "q2"]


def test_rejections_match_jax():
    """submit's checks raise the same error types in both servers; the
    port also rejects a tensor hiding in the kwargs."""
    bad = [
        dict(task="upscale"),
        dict(task="img2img"),
        dict(task="inpainting", image=tagged_image("x")),
        dict(lora="never-attached"),
        dict(init=np.zeros((4, 4, 3))),
        dict(init=tagged_image("y")),
    ]
    for kw in bad:
        errors = []
        for mod in (jserving, tserving):
            server = mod.GenerationServer(Recorder())
            with pytest.raises(Exception) as e:
                server.submit("a cat", **kw)
            errors.append(type(e.value))
        assert errors[0] == errors[1], kw
    with pytest.raises(TypeError, match="not batchable"):
        tserving.GenerationServer(Recorder()).submit("a cat", init=torch.zeros(3))
    with pytest.raises(ValueError, match="empty"):
        tserving.GenerationServer(Recorder()).attach_lora("a", {})


@pytest.mark.parametrize("value", [
    np.zeros((2, 3), np.float16), torch.zeros(2, 3), tagged_image("z", 16), 3,
    "text", None, 0.5,
])
def test_content_descriptor_and_shape_key(value):
    """The batching key of a request; a tensor keys like an array."""
    want_value = value.numpy() if isinstance(value, torch.Tensor) else value
    got = tserving._content_descriptor(value)
    want = jserving._content_descriptor(want_value)
    if isinstance(value, torch.Tensor):
        assert got == ("arr", (2, 3), "torch.float32") and want[:2] == got[:2]
    else:
        assert got == want
    kw = dict(prompt="p", kwargs={"h": 64, "w": value if got is None else 1},
              task="img2img", image=tagged_image("k"))
    assert tserving._Request(**kw).shape_key() == jserving._Request(**kw).shape_key()


@pytest.mark.parametrize("max_batch", range(1, 10))
def test_buckets_match_jax(max_batch):
    t = tserving.GenerationServer(Recorder(), max_batch=max_batch)
    j = jserving.GenerationServer(Recorder(), max_batch=max_batch)
    assert t._buckets() == j._buckets()
    assert [t._bucket_for(n) for n in range(1, 12)] == [
        j._bucket_for(n) for n in range(1, 12)]


def test_errors_reach_every_future_and_count():
    class Failing(Recorder):
        def generate_text2img(self, prompts, **kw):
            raise RuntimeError("device lost")

    server = tserving.GenerationServer(Failing(), max_batch=4)
    futs = [server.submit(f"p{i}") for i in range(3)]
    server.start()
    try:
        for f in futs:
            with pytest.raises(RuntimeError, match="device lost"):
                f.result(timeout=TIMEOUT)
    finally:
        server.stop()
    assert server.stats()["errors"] == 1


# --- the port's server on the port's small 2.1 pipeline -----------------------


def small_pipeline21():
    from kandinsky2_tpu_torch.configs import small_config
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
    from kandinsky2_tpu_torch.utils import stub_tokenizers

    tok1, tok2 = stub_tokenizers()
    pipe = Kandinsky2_1(config=small_config(), tokenizer1=tok1, tokenizer2=tok2,
                        dtype=torch.float32, device="cpu")
    pipe.init_random_params(torch.Generator().manual_seed(3))
    with torch.no_grad():  # the random MoVQ's image into [-1, 1]
        pipe.movq.decoder.conv_out.weight.mul_(0.01)
        pipe.movq.decoder.conv_out.bias.mul_(0.01)
    return pipe


def test_served_rows_equal_a_direct_batched_call():
    """3 requests coalesce into one bucket-4 call, and each served image is
    the row of a direct batch-4 call after the same ``set_seed`` (exact on
    the CPU: the same call in another thread)."""
    pipe = small_pipeline21()
    kw = dict(h=64, w=64, num_steps=4, prior_steps="3", guidance_scale=4)
    prompts = ["red cat", "blue dog", "green bird"]
    server = tserving.GenerationServer(pipe, max_batch=4)
    pipe.set_seed(7)
    served = run_sequence(server, [(p, kw) for p in prompts])
    s = server.stats()
    assert (s["requests"], s["batches"], s["padded"]) == (3, 1, 1)
    pipe.set_seed(7)
    direct = pipe.generate_text2img(prompts + prompts[-1:], batch_size=4, **kw)
    for i, imgs in enumerate(served):
        assert len(imgs) == 1
        np.testing.assert_array_equal(np.asarray(imgs[0]), np.asarray(direct[i]))
    assert np.asarray(direct[0]).std() > 0
    assert not np.array_equal(np.asarray(direct[0]), np.asarray(direct[1]))


# --- LoRA hot-swap -------------------------------------------------------------


def jax_adapters(jp, seed):
    """Two rank-4 adapters in the JAX package's layout ({path: {"down" [in,
    4], "up" [4, out]}}) on the kernels its ``default_target`` picks in the
    JAX UNet22, drawn from a numpy seed (``down`` as ``init_lora`` scales
    it, ``up`` non-zero so that both change the weights)."""
    from kandinsky2_tpu.models.lora import default_target
    from kandinsky2_tpu_torch.weights.from_jax import flatten

    rng = np.random.RandomState(seed)
    paths = [p for p, leaf in flatten(jp.params["unet"]).items()
             if leaf.ndim == 2 and default_target(p, leaf)]
    out = []
    for scale in (0.5, -0.3):
        out.append({})
        for p in paths:
            n_in, n_out = flatten(jp.params["unet"])[p].shape
            out[-1][p] = {
                "down": (rng.randn(n_in, 4) / n_in ** 0.5).astype(np.float32),
                "up": (scale * rng.randn(4, n_out)).astype(np.float32)}
    return out


def test_lora_hot_swap_matches_jax_merge_and_restores_base():
    """After ``_ensure_lora("a")`` the port's UNet equals the bridge of
    JAX's ``merge_lora`` within 1e-6 relative (scale 0.7 too); after
    a → b → None it is the base bitwise; a detached adapter never strands
    its fold."""
    from kandinsky2_tpu.models.lora import _get
    from kandinsky2_tpu.models.lora import merge_lora as jax_merge
    from kandinsky2_tpu_torch.weights.from_jax import lora_from_jax, torch_key_for
    from test_torch_common import shared_pair

    jp, tp, _ = shared_pair("2.2")
    ja, jb = jax_adapters(jp, 3)
    server = tserving.GenerationServer(tp)
    server.attach_lora("a", lora_from_jax(ja))
    server.attach_lora("b", lora_from_jax(jb), scale=0.7)
    base = {k: v.clone() for k, v in tp.unet.state_dict().items()}
    targeted = set(lora_from_jax(ja))
    assert len(targeted) == len(ja) > 10

    kernels = {}  # the targeted JAX kernels alone, as a tree merge_lora walks
    for path in ja:
        node = kernels
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = _get(jp.params["unet"], path)

    def check_merged(jax_loras, scale):
        merged = jax_merge(kernels, jax_loras, scale)
        for path in jax_loras:
            k = torch_key_for(path)
            # a Dense kernel [in, out] is the port's weight [out, in]
            w = torch.from_numpy(np.array(_get(merged, path)).T)
            v = tp.unet.state_dict()[k]
            err = float((v - w).abs().max())
            assert err <= 1e-6 * max(1.0, float(w.abs().max())), (k, err)
            assert not torch.equal(v, base[k]), k
        for k, v in tp.unet.state_dict().items():
            if k not in targeted:
                assert torch.equal(v, base[k]), k

    server._ensure_lora("a")
    check_merged(ja, 1.0)
    server._ensure_lora("b")
    check_merged(jb, 0.7)
    server._ensure_lora(None)
    for k, v in tp.unet.state_dict().items():
        assert torch.equal(v, base[k]), k
    assert server.stats()["lora_swaps"] == 3
    server._ensure_lora("a")
    server.detach_lora("a")
    server._ensure_lora(None)
    for k, v in tp.unet.state_dict().items():
        assert torch.equal(v, base[k]), k
    with pytest.raises(KeyError):
        server.submit("x", lora="a")
    with pytest.raises(KeyError, match="not in unet"):
        server.attach_lora("c", {"nope.weight": {"down": torch.zeros(1, 1),
                                                 "up": torch.zeros(1, 1)}})


def test_adapters_never_share_a_call_as_in_jax():
    """Requests a, a, None, b, a, None submitted at once: both servers make
    the same calls, each with the weights of its one adapter (the port's
    [out, in] weight against JAX's [in, out] kernel, within 1e-6)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    kernel = rng.randn(6, 5).astype(np.float32)
    facs = {name: {"down": rng.randn(6, 2).astype(np.float32),
                   "up": rng.randn(2, 5).astype(np.float32)} for name in "ab"}
    jax_pipe = Recorder(weight=lambda: np.asarray(jax_pipe.params["unet"]["l"]["kernel"]))
    jax_pipe.params = {"unet": {"l": {"kernel": jnp.asarray(kernel)}}}
    layer = torch.nn.Linear(6, 5, bias=False)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(kernel.T))
    port_pipe = Recorder(weight=lambda: layer.weight.detach().numpy().T.copy())
    port_pipe.models = lambda: {"unet": torch.nn.ModuleDict({"l": layer})}
    seq = [("p0", "a"), ("p1", "a"), ("p2", None), ("p3", "b"), ("p4", "a"),
           ("p5", None)]
    calls = {}
    for name, mod, pipe, key in (
            ("jax", jserving, jax_pipe, lambda n: ("l", "kernel")),
            ("port", tserving, port_pipe, lambda n: "l.weight")):
        server = mod.GenerationServer(pipe, max_batch=4)
        for n, f in facs.items():
            factors = f if name == "jax" else {k: torch.from_numpy(v) for k, v in f.items()}
            server.attach_lora(n, {key(n): factors})
        futs = [server.submit(p, lora=lo) for p, lo in seq]
        server.start()
        try:
            for f in futs:
                f.result(timeout=TIMEOUT)
        finally:
            server.stop()
        calls[name] = (pipe.calls, server.stats())
    (jc, js), (tc, ts) = calls["jax"], calls["port"]
    assert [c["prompts"] for c in tc] == [c["prompts"] for c in jc] == [
        ["p0", "p1", "p4", "p4"], ["p2", "p5"], ["p3"]]
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a["weight"], b["weight"], rtol=0, atol=1e-6)
    assert ts == js and ts["lora_swaps"] == 3
    np.testing.assert_allclose(tc[1]["weight"], kernel, rtol=0, atol=0)


# --- set_seed --------------------------------------------------------------------


def _global_draw_untouched(call):
    """Whether ``call()`` leaves torch's global generator where it was."""
    torch.manual_seed(123)
    want = torch.rand(4)
    torch.manual_seed(123)
    call()
    return torch.equal(torch.rand(4), want)


def test_set_seed_repeats_on_21():
    pipe = small_pipeline21()
    kw = dict(h=64, w=64, num_steps=4, prior_steps="3", output="float")
    pipe.set_seed(11)
    a = pipe.generate_text2img("red cat", **kw)
    pipe.set_seed(11)
    b = pipe.generate_text2img("red cat", **kw)
    c = pipe.generate_text2img("red cat", **kw)  # the generator moved on
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert _global_draw_untouched(lambda: pipe.generate_text2img(
        "red cat", sampler="p_sampler", **kw))
    assert _global_draw_untouched(lambda: pipe.generate_img2img(
        "red cat", Image.new("RGB", (64, 64)), strength=0.5, **kw))


def test_set_seed_repeats_on_22():
    from kandinsky2_tpu_torch.configs import small_overrides22
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_2
    from kandinsky2_tpu_torch.utils import stub_tokenizer22

    pipe = Kandinsky2_2(tokenizer=stub_tokenizer22(64), overrides=small_overrides22(32),
                        dtype=torch.float32, device="cpu")
    pipe.init_random_params(torch.Generator().manual_seed(4))
    kw = dict(h=64, w=64, decoder_steps=3, prior_steps=3, output="float")
    pipe.set_seed(11)
    a = pipe.generate_text2img("red cat", **kw)
    pipe.set_seed(11)
    b = pipe.generate_text2img("red cat", **kw)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, pipe.generate_text2img("red cat", **kw))
    assert _global_draw_untouched(lambda: pipe.generate_text2img("red cat", **kw))
    # the default seed is the JAX pipelines' (0), as on 2.0
    fresh = Kandinsky2_2(tokenizer=stub_tokenizer22(64),
                         overrides=small_overrides22(32), dtype=torch.float32,
                         device="cpu")
    for name, model in fresh.models().items():
        model.load_state_dict(pipe.models()[name].state_dict())
    pipe.set_seed(0)
    np.testing.assert_array_equal(fresh.generate_text2img("red cat", **kw),
                                  pipe.generate_text2img("red cat", **kw))
