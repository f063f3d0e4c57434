"""One-command validation harness, the counterpart of
``kandinsky2_tpu/validate.py``:

    python -m kandinsky2_tpu_torch.validate --version 2.1 --out report.json

Stages (each recorded in the JSON report; the harness runs as far as it
can and reports exactly where it stopped):

1. **fetch**    — the published checkpoints, from the local cache
                  (``weights.hub``: nothing is downloaded, so with no
                  cache the report ends ``"stopped_at": "fetch"``, where
                  the JAX package's offline run stops too).
2. **build**    — the pipeline, loaded from them (``weights.load_kandinsky*``;
                  2.1 and 2.0 stop here, their sentencepiece tokenizers
                  unreadable without ``transformers``) or made by
                  ``pipe_builder``.
3. **generate** — seeded generation (``set_seed``) at a fixed prompt, size
                  and step count.
4. **metrics**  — PSNR / windowed SSIM / MS-SSIM / CLIP-cosine drift
                  against stored reference images (``reference_dir``),
                  and the BASELINE LPIPS < 0.02 gate with
                  ``lpips_weights`` (a file of ``lpips.save_lpips_weights``
                  or of the JAX package's converter); without weights the
                  report marks it *not evaluated* rather than faking it.
5. **report**   — one JSON document with per-stage status.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import tempfile
import time
import traceback
from typing import Callable, Optional

import numpy as np

VALIDATION_PROMPT = "red cat, 4k photo"
SEED = 0


def _stage(report: dict, name: str, fn: Callable):
    """Run one stage, recording status/duration; re-raises _StopValidation."""
    t0 = time.time()
    entry = {"status": "running"}
    report["stages"][name] = entry
    try:
        out = fn()
        entry["status"] = "ok"
        return out
    except Exception as e:  # noqa: BLE001 - every failure goes in the report
        entry["status"] = "failed"
        entry["error"] = f"{type(e).__name__}: {e}"
        entry["traceback"] = traceback.format_exc(limit=8)
        raise _StopValidation(name) from e
    finally:
        entry["seconds"] = round(time.time() - t0, 3)


class _StopValidation(Exception):
    def __init__(self, stage: str):
        self.stage = stage
        super().__init__(stage)


def lpips_available() -> bool:
    """Whether the optional ``lpips`` package is installed (the card's
    machine has none; ``lpips.py`` is the port's own LPIPS)."""
    return importlib.util.find_spec("lpips") is not None


def compute_lpips(img_a, img_b) -> Optional[float]:
    """LPIPS (AlexNet) through the optional ``lpips`` package where it is
    installed, loaded at call time only; else None."""
    if not lpips_available():
        return None
    import torch

    net = importlib.import_module("lpips").LPIPS(net="alex")
    to_t = lambda im: torch.from_numpy(
        np.asarray(im, np.float32).transpose(2, 0, 1)[None] / 127.5 - 1.0
    )
    with torch.no_grad():
        return float(net(to_t(img_a), to_t(img_b)).item())


def run_generation(pipe, *, h: int = 256, w: int = 256, num_steps: int = 20,
                   sampler: str = "ddim_sampler", prompt: str = VALIDATION_PROMPT,
                   seed: int = SEED, **kw):
    """Stage 3: seeded generation (2.0 and 2.1)."""
    pipe.set_seed(seed)
    return pipe.generate_text2img(prompt, num_steps=num_steps, h=h, w=w,
                                  sampler=sampler, **kw)


def run_generation_22(pipe, *, h: int = 256, w: int = 256,
                      decoder_steps: int = 20, prior_steps: int = 10,
                      sampler: str = "ddpm",
                      prompt: str = VALIDATION_PROMPT, seed: int = SEED):
    """Stage 3 for 2.2."""
    pipe.set_seed(seed)
    return pipe.generate_text2img(prompt, decoder_steps=decoder_steps,
                                  prior_steps=prior_steps, h=h, w=w,
                                  sampler=sampler)


def run_metrics(report: dict, images, reference_dir: Optional[str],
                out_dir: str, pipe=None, lpips_weights: Optional[str] = None,
                lpips_device="cuda") -> None:
    """Stage 4: save outputs; compare against stored reference images.

    ``lpips_weights``: a safetensors file of ``lpips.save_lpips_weights``
    (or of the JAX package's converter); when given, the BASELINE
    LPIPS<0.02 gate runs on ``lpips_device`` with the port's own LPIPS."""
    from .eval import clip_perceptual_distance, ms_ssim, psnr, ssim

    native_lpips = None
    if lpips_weights:
        from .lpips import load_lpips_weights, lpips_images

        _lp_params = load_lpips_weights(lpips_weights, lpips_device)
        native_lpips = lambda x, y: lpips_images(_lp_params, x, y)

    os.makedirs(out_dir, exist_ok=True)
    out_paths = []
    for i, im in enumerate(images):
        p = os.path.join(out_dir, f"generated_{i}.png")
        im.save(p)
        out_paths.append(p)
    report["outputs"] = out_paths

    if not reference_dir:
        report["metrics"] = {
            "note": "no --reference-dir given; outputs saved as the new "
                    "reference set (bootstrap mode)"
        }
        return
    from PIL import Image

    metrics = []
    for i, im in enumerate(images):
        ref_path = os.path.join(reference_dir, f"generated_{i}.png")
        if not os.path.exists(ref_path):
            metrics.append({"index": i, "error": f"missing {ref_path}"})
            continue
        ref = Image.open(ref_path).convert("RGB")
        a = np.asarray(im, np.float64)
        b = np.asarray(ref, np.float64)
        m = {
            "index": i,
            "psnr_db": round(psnr(a, b), 3),
            "ssim": round(ssim(a, b), 5),
            # multi-scale SSIM: the strongest offline perceptual proxy
            "ms_ssim": round(ms_ssim(a, b), 5),
        }
        if native_lpips is not None:
            lp = native_lpips(im, ref)
            m["lpips_backend"] = "native-torch"
        else:
            lp = compute_lpips(im, ref)
            if lp is not None:
                m["lpips_backend"] = "lpips-pkg"
        if lp is not None:
            m["lpips_alex"] = round(lp, 5)
            m["lpips_gate_0.02"] = bool(lp < 0.02)
        else:
            m["lpips_alex"] = None
            m["lpips_gate_0.02"] = (
                "not evaluated: pass --lpips-weights FILE (converted via "
                "python -m kandinsky2_tpu_torch.lpips) or install lpips"
            )
        if pipe is not None and hasattr(pipe, "encode_images"):
            m["clip_cosine_drift"] = round(
                clip_perceptual_distance(pipe, im, ref), 5
            )
        metrics.append(m)
    report["metrics"] = metrics


def _load(report: dict, version: str, task_type: str, cache_dir: str,
          use_auth_token):
    """Stages fetch and build: the pipeline of ``version`` from the cached
    checkpoints (``weights.hub``, ``weights.load_kandinsky*``).  2.1 and
    2.0 stop at build: their XLM-R and mT5 tokenizers need files only
    ``transformers`` reads (pass ``pipe_builder`` instead)."""
    from .weights import hub

    if version == "2.2":
        from .weights.load_kandinsky22 import build_kandinsky22

        paths = _stage(report, "fetch", lambda: hub.fetch_2_2(
            cache_dir, task_type, use_auth_token))
        return _stage(report, "build", lambda: build_kandinsky22(
            paths["prior_dir"], paths["decoder_dir"], task_type=task_type))
    from .weights import load_kandinsky

    fetch = hub.fetch_2_1 if version == "2.1" else hub.fetch_2_0
    build = (load_kandinsky.build_kandinsky21 if version == "2.1"
             else load_kandinsky.build_kandinsky20)
    paths = _stage(report, "fetch", lambda: fetch(cache_dir, task_type, use_auth_token))
    return _stage(report, "build", lambda: build(paths, task_type=task_type))


def validate(version: str = "2.1", task_type: str = "text2img",
             cache_dir: str = "/tmp/kandinsky2", out_dir: Optional[str] = None,
             reference_dir: Optional[str] = None, h: int = 256, w: int = 256,
             num_steps: int = 20, sampler: Optional[str] = None,
             use_auth_token=None,
             pipe_builder: Optional[Callable] = None,
             lpips_weights: Optional[str] = None) -> dict:
    """Run the validation ladder; returns the report dict.

    ``pipe_builder`` returns the pipeline to validate (stages 1-2); without
    it the pipeline is loaded from the checkpoints cached under
    ``cache_dir`` (nothing is downloaded).  ``out_dir`` defaults to
    ``k2_validate`` under the temporary directory.
    """
    if version not in ("2.0", "2.1", "2.2"):
        raise ValueError(f"unknown version {version!r}")
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "k2_validate")
    report = {
        "version": version, "task_type": task_type, "prompt": VALIDATION_PROMPT,
        "seed": SEED, "h": h, "w": w, "num_steps": num_steps,
        "stages": {}, "ok": False,
    }
    try:
        if pipe_builder is None:
            pipe = _load(report, version, task_type, cache_dir, use_auth_token)
        else:
            pipe = _stage(report, "build", pipe_builder)

        if version == "2.2":
            images = _stage(report, "generate", lambda: run_generation_22(
                pipe, h=h, w=w, decoder_steps=num_steps,
                sampler=sampler or "ddpm"))
        else:
            images = _stage(report, "generate", lambda: run_generation(
                pipe, h=h, w=w, num_steps=num_steps,
                sampler=sampler or "ddim_sampler"))
        _stage(report, "metrics", lambda: run_metrics(
            report, images, reference_dir, out_dir,
            pipe=pipe if version != "2.2" else None,
            lpips_weights=lpips_weights, lpips_device=pipe.device))
        report["ok"] = True
    except _StopValidation as stop:
        report["stopped_at"] = stop.stage
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kandinsky2_tpu_torch.validate",
        description="fetch -> build -> seeded generate -> metrics -> JSON",
    )
    ap.add_argument("--version", default="2.1", choices=["2.0", "2.1", "2.2"])
    ap.add_argument("--task-type", default="text2img")
    ap.add_argument("--cache-dir", default="/tmp/kandinsky2",
                    help="the local cache of the published checkpoints")
    ap.add_argument("--out-dir", default=None,
                    help="where the images go (k2_validate under the "
                    "temporary directory by default)")
    ap.add_argument("--reference-dir", default=None,
                    help="directory of stored reference generated_<i>.png")
    ap.add_argument("--out", default=None, help="report JSON path")
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--w", type=int, default=256)
    ap.add_argument("--num-steps", type=int, default=20)
    ap.add_argument("--sampler", default=None,
                    help="override the sampler (e.g. dpmpp_sampler / dpmpp) "
                    "for sampler-quality comparisons against a reference set")
    ap.add_argument("--lpips-weights", default=None,
                    help="converted LPIPS safetensors (python -m "
                    "kandinsky2_tpu_torch.lpips --alex ... --lin ... --out "
                    "FILE); runs the BASELINE LPIPS<0.02 gate")
    args = ap.parse_args(argv)

    report = validate(
        version=args.version, task_type=args.task_type, cache_dir=args.cache_dir,
        out_dir=args.out_dir,
        reference_dir=args.reference_dir, h=args.h, w=args.w,
        num_steps=args.num_steps, sampler=args.sampler,
        lpips_weights=args.lpips_weights,
    )
    text = json.dumps(report, indent=2, default=str)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
