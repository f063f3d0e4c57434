"""Seeded weights and random streams, the same for the program and the
reference.

``param_specs`` lists every parameter of the reference models with the
distribution it is drawn from (the port's own rule for random weights:
N(0, 1/fan_in) for linear and convolution weights, a tenth of that for the
last layer of each residual branch, N(0, 0.02²) for biases and embeddings,
N(0, 1/rows) for projection matrices, N(0, 0.01²) for other free
parameters, norms at weight 1 and bias 0, the 2.2 prior's clip_std around
1).  ``draw`` makes them all on the device in one ``randn`` call of the
served dtype; the program loads them by name and the reference takes the
same values.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from .reference.layers import Conv2d, GroupNorm32, LayerNormF32, Linear

# tags of the independent random streams drawn from one --seed
WEIGHTS, PROMPTS, NOISE, BATCHES = 1, 2, 3, 4


def load_words(traffic: dict) -> list:
    """The word list that a traffic file names, from ``traffic/``."""
    with open(os.path.join(os.path.dirname(__file__), "traffic", traffic["words"])) as f:
        return f.read().split()


def stream_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed of the stream ``keys`` of ``seed``."""
    hi, lo = np.random.SeedSequence([int(seed) % 2**64, *keys]).generate_state(2)
    return ((int(hi) << 32) | int(lo)) % 2**63


def param_specs(models: dict, residual_outputs) -> list:
    """[(model, name, shape, std, mean)] in a fixed order."""
    out = []
    for mname, model in models.items():
        for mod_name, mod in model.named_modules():
            gain = 0.1 if mod_name.endswith(tuple(residual_outputs)) else 1.0
            for pname, p in mod.named_parameters(recurse=False):
                full = f"{mod_name}.{pname}" if mod_name else pname
                if isinstance(mod, (GroupNorm32, LayerNormF32)):
                    std, mean = 0.0, 1.0 if pname == "weight" else 0.0
                elif pname == "bias" or isinstance(mod, nn.Embedding):
                    std, mean = 0.02, 0.0
                elif isinstance(mod, (Linear, Conv2d)):
                    std, mean = gain * p[0].numel() ** -0.5, 0.0
                elif pname in ("text_projection", "proj"):
                    std, mean = p.shape[0] ** -0.5, 0.0
                elif pname == "clip_std":
                    std, mean = 0.1, 1.0
                else:
                    std, mean = 0.01, 0.0
                out.append((mname, full, tuple(p.shape), std, mean))
    return out


def draw(specs: list, seed: int, dtype, device) -> dict:
    """{model: {name: tensor}}: one ``randn`` over every parameter, each
    slice scaled and shifted to its distribution."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, WEIGHTS))
    total = sum(math.prod(s[2]) for s in specs)
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    out, o = {}, 0
    for mname, name, shape, std, mean in specs:
        n = math.prod(shape)
        v = flat[o:o + n].view(shape)
        o += n
        if std != 1.0:
            v.mul_(std)
        if mean:
            v.add_(mean)
        out.setdefault(mname, {})[name] = v
    return out
