"""What the benchmark's tests share: the tiny configurations and traffic
of ``data/`` and a cell spec built from them."""

from __future__ import annotations

import json
import os

DATA = os.path.join(os.path.dirname(__file__), "data")


def load(name: str) -> dict:
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def tiny_spec(cell: str, dtype: str = None) -> dict:
    """The cell's own file (name, limits) over the tiny configuration and
    traffic of its kind; ``dtype`` overrides the compute dtype."""
    from bench_h100.run import cell_spec

    spec = cell_spec(cell)
    tiny = {"t2i22-768-b4": ("tiny22.json", "tiny-t2i.json"),
            "train21-768-b32": ("tiny21.json", "tiny-train.json")}[cell]
    spec["cfg"], spec["tr"] = load(tiny[0]), load(tiny[1])
    if dtype:
        spec["cfg"]["dtype"] = dtype
    return spec
