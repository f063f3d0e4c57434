"""The port's HTTP front end against the JAX package's: the same requests
get the same status codes (200, 400 for a bad request or an undecodable
image, 404 for an unknown path, 500 for a failed generation) and base64
PNGs that decode to the pipeline's images; ``parse_warmup_spec`` agrees;
``main`` without ``--small`` refuses to serve random weights in place of
the published checkpoints.

Every server and HTTP thread a test starts is stopped in ``finally``, and
every HTTP call has its own timeout."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from kandinsky2_tpu import serving as jserving
from kandinsky2_tpu import serving_http as jhttp
from kandinsky2_tpu_torch import serving as tserving
from kandinsky2_tpu_torch import serving_http as thttp

TIMEOUT = 30  # seconds for any one HTTP call


def colour(prompt):
    return tuple(int(b) for b in prompt.encode()[:3].ljust(3, b"\0"))


class Painter:
    """A pipeline without a model: text2img paints each row in its
    prompt's colour at h x w, img2img hands back its init images; the
    prompt "fail" raises."""

    def generate_text2img(self, prompts, h=64, w=64, **kw):
        if "fail" in prompts:
            raise RuntimeError("generation failed")
        return [Image.new("RGB", (w, h), colour(p)) for p in prompts]

    def generate_img2img(self, prompts, images, **kw):
        return list(images)


def png_b64(img):
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def decode(b64):
    return Image.open(io.BytesIO(base64.b64decode(b64)))


def exchange(port, method, path, body=None):
    """(status, JSON body) of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def session(serving, http):
    """Every request kind against one front end; returns (status, decoded
    images' sizes and pixels or the error's presence) per request."""
    rng = np.random.RandomState(0)
    init = Image.fromarray(rng.randint(0, 256, (24, 40, 3), np.uint8))
    server = serving.GenerationServer(Painter(), max_batch=2)
    httpd = http.serve_http(server, host="127.0.0.1", port=0, start=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    out = []
    try:
        for method, path, body in [
            ("GET", "/healthz", None),
            ("GET", "/nope", None),
            ("POST", "/nope", {"prompt": "cat"}),
            ("POST", "/generate", {"prompt": "cat", "h": 32, "w": 48}),
            ("POST", "/generate", {"prompt": "dog", "task": "img2img",
                                   "image": png_b64(init), "strength": 0.5}),
            ("POST", "/generate", {"prompt": "dog", "task": "img2img",
                                   "image": base64.b64encode(b"not a png").decode()}),
            ("POST", "/generate", {"h": 32}),
            ("POST", "/generate", {"prompt": "cat", "task": "upscale"}),
            ("POST", "/generate", {"prompt": "cat", "task": "img2img"}),
            ("POST", "/generate", {"prompt": "fail"}),
        ]:
            code, reply = exchange(port, method, path, body)
            if "images" in reply:
                imgs = [decode(b) for b in reply["images"]]
                reply = [(im.format, im.size, np.asarray(im.convert("RGB")).tolist())
                         for im in imgs]
            elif "error" in reply:
                reply = "error"
            out.append((method, path, code, reply))
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
        thread.join(timeout=TIMEOUT)
    assert not thread.is_alive()
    return out, init


def test_http_codes_and_images_match_jax():
    got, init = session(tserving, thttp)
    want, _ = session(jserving, jhttp)
    assert got == want
    codes = [c for _, _, c, _ in got]
    assert codes == [200, 404, 404, 200, 200, 400, 400, 400, 400, 500]
    assert got[0][3] == {"ok": True}
    (fmt, size, pixels), = got[3][3]
    assert fmt == "PNG" and size == (48, 32)
    assert np.all(np.asarray(pixels) == colour("cat"))
    (_, size, pixels), = got[4][3]
    np.testing.assert_array_equal(np.asarray(pixels, np.uint8), np.asarray(init))


@pytest.mark.parametrize("spec", [
    "h=768,w=768,num_steps=50", "h=512, w=512 ,task=img2img", "", "prior_steps=ddim5,",
    "sampler=p_sampler,guidance_scale=4",
])
def test_parse_warmup_spec_matches_jax(spec):
    assert thttp.parse_warmup_spec(spec) == jhttp.parse_warmup_spec(spec)


def test_parse_warmup_spec_rejects_like_jax():
    for mod in (thttp, jhttp):
        with pytest.raises(ValueError, match="key=value"):
            mod.parse_warmup_spec("h=64,oops")


def test_main_without_small_names_the_missing_loaders():
    """Without ``--small`` the server loads the cached checkpoints: with no
    cache it stops naming the missing file, and serves nothing."""
    with pytest.raises(FileNotFoundError, match="not in the cache"):
        thttp.main(["--version", "2.2", "--port", "0"])


@pytest.mark.parametrize("version", ["2.0", "2.1", "2.2"])
def test_small_pipelines(version):
    """``--small``'s pipelines: bf16 on the requested device, the UNet's
    heads 64 wide (the flash kernel's width)."""
    pipe = thttp.build_small_pipeline(version, device="cpu")
    assert pipe.device == torch.device("cpu") and pipe.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for m in pipe.models().values()
               for p in m.parameters())
    if version == "2.2":
        from kandinsky2_tpu_torch.models.unet22 import AddedKVAttention

        attn = [m for m in pipe.unet.modules() if isinstance(m, AddedKVAttention)]
        assert attn and all(m.to_q.weight.shape[0] // m.heads == 64 for m in attn)
    else:
        assert pipe.config["model_config"]["num_head_channels"] == 64
