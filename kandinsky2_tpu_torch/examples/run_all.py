"""Run every example with ``--small`` in one process (the counterpart of the
repository's ``examples/run_all.sh``):

    python -m kandinsky2_tpu_torch.examples.run_all [--device cuda] [--out DIR]

Each script runs through ``runpy`` as ``__main__`` with its flags in
``sys.argv``.  ``run_example`` returns its seconds, its printed lines and
the float images its pipelines produced before the 8-bit conversion (every
``Pipeline._output`` call), and ``check_example`` holds them to what the
script must make: finite pixels, the last image of the stated size (the
hires script's first stage is half its size), or the steps it trains.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import runpy
import sys
import time

import numpy as np

# name: (extra flags, the images' size or None, the steps it trains or None)
EXAMPLES = {
    "text2img_21": ([], 64, None),
    "img2img_21": ([], 64, None),
    "inpainting_21": ([], 64, None),
    "mix_images_21": ([], 64, None),
    "hires_21": ([], 128, None),
    "text2img_20": ([], 64, None),
    "img2img_20": ([], 512, None),     # 2.0 img2img and inpainting work at
    "inpainting_20": ([], 512, None),  # 512², as the reference does
    "text2img_22": ([], 64, None),
    "controlnet_22": ([], 64, None),
    "lora_22": ([], 64, None),
    "train_lora_22": (["--steps", "3"], 64, 3),
    "distill_22": (["--steps", "3"], 64, 3),
    "train_decoder": ([], None, 8),
    "train_prior": ([], None, 8),
    "serving_bench": (["--n", "2", "--steps", "2"], 64, None),
    "serving_lora": ([], 64, None),
    "bf16_stress_768": (["--steps", "4"], 64, None),
    "train_sp": (["--sp", "2", "--steps", "2"], None, 2),  # 2 ranks, no image
}
# the scripts with flags of their own (no ``--out``)
OWN_FLAGS = {"train_sp"}


@contextlib.contextmanager
def _recording_outputs(images: list):
    """Record the float images of every ``Pipeline._output`` call."""
    from ..pipelines.base import Pipeline

    inner = Pipeline.__dict__["_output"]

    def record(images_, output, h=None, w=None):
        images.append(images_[:, :h, :w, :].float().cpu().numpy())
        return inner.__func__(images_, output, h, w)

    Pipeline._output = staticmethod(record)
    try:
        yield
    finally:
        Pipeline._output = inner


def run_example(name: str, device: str, out_dir: str) -> dict:
    """Run ``kandinsky2_tpu_torch.examples.<name>`` with ``--small``, its
    EXAMPLES flags and ``--out`` under ``out_dir``; new temporary
    directories (the trainers' checkpoints) go under ``out_dir`` too."""
    import tempfile

    flags, _, _ = EXAMPLES[name]
    out = os.path.join(out_dir, f"{name}.png")
    argv = [name, "--small", "--device", device,
            *([] if name in OWN_FLAGS else ["--out", out]), *flags]
    images, printed = [], io.StringIO()
    saved_argv, saved_tmp = sys.argv, tempfile.tempdir
    sys.argv, tempfile.tempdir = argv, out_dir
    t0 = time.perf_counter()
    try:
        with _recording_outputs(images), contextlib.redirect_stdout(printed):
            runpy.run_module(f"{__package__}.{name}", run_name="__main__", alter_sys=True)
            if device == "cuda":
                import torch

                torch.cuda.synchronize()
    finally:
        sys.argv, tempfile.tempdir = saved_argv, saved_tmp
    return {"name": name, "seconds": time.perf_counter() - t0, "images": images,
            "lines": printed.getvalue().splitlines(), "out": out}


def check_example(result: dict) -> str:
    """Raise AssertionError unless ``result`` holds what its script makes;
    returns a one-line summary."""
    name = result["name"]
    _, size, steps = EXAMPLES[name]
    lines = result["lines"]
    what = []
    if size is not None:
        assert result["images"], f"{name}: no image was produced"
        last = result["images"][-1].shape
        assert last[1:] == (size, size, 3), f"{name}: images {last}"
        assert all(np.isfinite(img).all() for img in result["images"]), \
            f"{name}: non-finite pixels"
        what.append(f"{sum(len(i) for i in result['images'])} image(s), the last "
                    f"{size}²")
    if any(line.startswith("saved ") for line in lines):
        from PIL import Image

        with Image.open(result["out"]) as im:
            assert im.size == (size, size), f"{name}: saved {im.size}"
    if steps is not None:
        found = lambda pattern: [int(m.group(1)) for line in lines
                                 for m in [re.match(pattern, line)] if m]
        # "trained to step N", or train_sp's "step N: {...} (1.23s)" after each
        trained = (found(r"trained to step (\d+)")
                   or found(r"step (\d+): \{.*\} \([\d.]+s\)$"))
        logged = found(r"step (\d+):")
        done = trained[-1] if trained else (logged[-1] + 1 if logged else 0)
        assert done == steps, f"{name}: trained {done} steps, not {steps}"
        what.append(f"{steps} steps")
    return f"{name}: {', '.join(what) or 'ran'} in {result['seconds']:.2f} s"


def main(argv=None):
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="output directory (a new one by default)")
    args = ap.parse_args(argv)
    out_dir = args.out or tempfile.mkdtemp(prefix="k2_examples_")
    os.makedirs(out_dir, exist_ok=True)
    for name in EXAMPLES:
        print(check_example(run_example(name, args.device, out_dir)), flush=True)
    print(f"all {len(EXAMPLES)} examples ok -> {out_dir}")


if __name__ == "__main__":
    main()
