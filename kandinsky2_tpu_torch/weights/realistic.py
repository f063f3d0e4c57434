"""Realistic-scale random weights for bf16-robustness runs, the counterpart
of ``kandinsky2_tpu/weights/realistic.py``.

Random weights drawn small under-stress bf16; published checkpoints carry
torch-default init statistics: kaiming_uniform(a=√5) kernels and N(0, 1)
embeddings (the reference's kandinsky2/model/nn.py uses torch module
defaults, and its zero_module outputs stay zero).  ``torch_init_stats``
resamples a module in place to those per-layer statistics, so the whole
pipeline runs in bf16 at a real checkpoint's activation magnitudes.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def torch_init_stats(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Resample ``module``'s weights in place from ``generator``:

    * the weight of every linear layer and convolution (what the JAX
      package calls a ``kernel``) -> U(-b, b) with b = 1/√fan_in, fan_in =
      in·kh·kw of an [out, in, kh, kw] weight (flax's prod(shape[:-1]));
      all-zero weights stay zero (the reference's zero_module outputs);
    * every embedding table -> N(0, 1);
    * norms, biases and every other tensor unchanged.

    The draws are fp32 on the generator's device, cast to each weight's
    dtype.  Returns ``module``."""
    dev = generator.device
    for mod in module.modules():
        w = getattr(mod, "weight", None)
        if not isinstance(w, nn.Parameter) or not w.is_floating_point() or not w.numel():
            continue
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            if not bool(w.any()):
                continue
            bound = w[0].numel() ** -0.5
            new = torch.rand(w.shape, generator=generator, device=dev) * (2 * bound) - bound
        elif isinstance(mod, nn.Embedding):
            new = torch.randn(w.shape, generator=generator, device=dev)
        else:
            continue
        w.copy_(new)
    return module
