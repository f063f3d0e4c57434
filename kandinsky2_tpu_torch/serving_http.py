"""Minimal HTTP front end over ``serving.GenerationServer`` (standard
library only), the counterpart of ``kandinsky2_tpu/serving_http.py``.

One process owns the card (the GenerationServer's device thread), an
``http.server.ThreadingHTTPServer`` accepts concurrent JSON requests, and
requests from different clients coalesce into one pipeline call through
the server's micro-batching queue.

    POST /generate {"prompt": "...", "task": "text2img", "h": 768, ...}
        -> {"images": ["<base64 png>", ...]}
      img2img/inpainting carry "image" (and "image_mask") as base64-encoded
      image files; every other field is forwarded as a pipeline kwarg.
    GET /healthz -> {"ok": true}

Run: ``python -m kandinsky2_tpu_torch.serving_http --small --port 8000``
(a small random-weight pipeline on the card; ``--device cpu`` for the
CPU) or embed ``serve_http(server, port=...)``.  Without ``--small`` it
loads the published checkpoints from the default cache
(``get_kandinsky2``; nothing is downloaded, a missing file stops it, and
2.1 and 2.0 stop for want of their sentencepiece tokenizers), and never
serves random weights in their place.
"""

from __future__ import annotations

import base64
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .serving import GenerationServer


def _decode_image(b64: str):
    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")


def _encode_image(img) -> str:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def make_handler(server: GenerationServer, timeout_s: float = 600.0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt = req.pop("prompt")
                task = req.pop("task", "text2img")
                image = req.pop("image", None)
                image_mask = req.pop("image_mask", None)
                fut = server.submit(
                    prompt, task=task,
                    image=_decode_image(image) if image else None,
                    image_mask=_decode_image(image_mask) if image_mask else None,
                    **req,
                )
            except (KeyError, ValueError, TypeError, OSError) as e:
                # OSError covers PIL.UnidentifiedImageError on undecodable
                # image payloads — still a client error, answer 400
                self._json(400, {"error": str(e)})
                return
            try:
                images = fut.result(timeout=timeout_s)
            except Exception as e:  # generation failure -> 500 with reason
                self._json(500, {"error": str(e)})
                return
            self._json(200, {"images": [_encode_image(im) for im in images]})

    return Handler


def serve_http(server: GenerationServer, host: str = "0.0.0.0",
               port: int = 8000, timeout_s: float = 600.0,
               start: bool = True) -> ThreadingHTTPServer:
    """Create (and by default start serving on the calling thread) an HTTP
    server bridging JSON requests into the GenerationServer's batching
    queue.  With ``start=False`` the caller drives ``serve_forever`` itself
    (tests run it on a thread).  ``port=0`` picks a free port
    (``httpd.server_address[1]``)."""
    server.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(server, timeout_s))
    if start:
        try:
            httpd.serve_forever()
        finally:
            server.stop()
    return httpd


def parse_warmup_spec(spec: str) -> dict:
    """``"h=768,w=768,num_steps=50,task=img2img"`` -> kwargs dict for
    ``GenerationServer.warmup``.  Integer-looking values become ints so they
    match the static shape keys real requests produce."""
    out = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"warmup spec item {item!r} is not key=value")
        k, v = item.split("=", 1)
        try:
            out[k.strip()] = int(v)
        except ValueError:
            out[k.strip()] = v.strip()
    return out


def build_small_pipeline(version: str = "2.1", device="cuda"):
    """A small pipeline of ``version`` in bf16 on ``device`` with random
    weights from seed 0 and the stand-in tokenizers: 2.1 at
    ``configs.small_config``, 2.0 at ``configs.small_config20``, 2.2 at
    ``configs.small_overrides22`` (each with 64-wide UNet heads, the width
    the flash kernel takes)."""
    import torch

    from .configs import small_config, small_config20, small_overrides22
    from .pipelines import Kandinsky2, Kandinsky2_1, Kandinsky2_2
    from .utils import stub_tokenizer22, stub_tokenizers

    kw = dict(dtype=torch.bfloat16, device=device)
    if version == "2.1":
        tok1, tok2 = stub_tokenizers()
        pipe = Kandinsky2_1(config=small_config(64), tokenizer1=tok1,
                            tokenizer2=tok2, **kw)
    elif version == "2.0":
        tok, _ = stub_tokenizers(64)
        pipe = Kandinsky2(config=small_config20(64), tokenizer1=tok,
                          tokenizer2=tok, **kw)
    elif version == "2.2":
        pipe = Kandinsky2_2(tokenizer=stub_tokenizer22(64),
                            overrides=small_overrides22(), **kw)
    else:
        raise ValueError(f"unknown version {version!r}")
    pipe.init_random_params(torch.Generator(device=device).manual_seed(0))
    return pipe


def main(argv: Optional[list] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--version", default="2.1", choices=["2.0", "2.1", "2.2"])
    ap.add_argument("--small", action="store_true",
                    help="small random-weight pipeline (no checkpoints)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--warmup", action="append", default=[],
                    metavar="SPEC",
                    help='run a serving set once before binding the port; '
                         'repeatable, e.g. --warmup "h=768,w=768,num_steps=50" '
                         '--warmup "h=512,w=512,task=img2img"')
    args = ap.parse_args(argv)

    if args.small:
        pipe = build_small_pipeline(args.version, args.device)
    else:
        from . import get_kandinsky2

        pipe = get_kandinsky2(args.device, task_type="text2img",
                              model_version=args.version)
    server = GenerationServer(pipe, max_batch=args.max_batch)
    if args.warmup:
        import time

        t0 = time.perf_counter()
        server.warmup([parse_warmup_spec(s) for s in args.warmup])
        print(f"warmup: {len(args.warmup)} serving set(s) run in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    print(f"serving {args.version} on {args.host}:{args.port}", flush=True)
    serve_http(server, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
