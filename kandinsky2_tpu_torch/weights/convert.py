"""Reference checkpoint -> port module, the counterpart of
``kandinsky2_tpu/weights/convert.py``.

The port's modules carry the reference state_dict names, so a reference
key maps onto a port key one to one, after an optional ``prefix`` and
``rename``.  The layouts are the reference's too, with one exception this
module owns: a 1x1 convolution (OI11) or a width-1 conv1d (OI1) that the
port holds as a ``Linear`` (OI), or the other way round.  The flax layouts
stay in ``weights/from_jax.py``.

Values stay in the checkpoint's dtype here; :func:`load_state_dict` casts
each onto the module's own parameter (exact where the module is fp32 or
shares the file's dtype).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn


def clip_rename(torch_key: str) -> str:
    """OpenAI CLIP's fused attention: the port's ``attn.in_proj.{weight,
    bias}`` is the archive's ``attn.in_proj_{weight,bias}``."""
    return torch_key.replace("attn.in_proj.weight", "attn.in_proj_weight").replace(
        "attn.in_proj.bias", "attn.in_proj_bias")


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.from_numpy(np.ascontiguousarray(value))


def _strip_ones(shape: tuple) -> tuple:
    while len(shape) > 2 and shape[-1] == 1:
        shape = shape[:-1]
    return shape


def _fit(key: str, value: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``value`` in the port's ``shape``: as it is, or a 1x1 conv / conv1d
    kernel to a linear one and back."""
    got = tuple(value.shape)
    if got == shape:
        return value
    if len(got) >= 2 and len(shape) >= 2 and _strip_ones(got) == _strip_ones(shape):
        return value.reshape(shape)
    raise ValueError(f"shape mismatch for {key}: checkpoint {got}, port {shape}")


def _source_key(key: str, prefix: str, rename: Optional[Callable[[str], str]]) -> str:
    tk = prefix + key
    return rename(tk) if rename is not None else tk


def convert_state_dict(
    state_dict: Mapping[str, object],
    module: nn.Module,
    *,
    prefix: str = "",
    rename: Optional[Callable[[str], str]] = None,
    strict: bool = True,
) -> dict:
    """{port key: tensor} of ``module`` from a reference ``state_dict``
    ({key: tensor or numpy array}).  ``prefix`` goes before every port key
    (``"model."`` for the 2.1 prior), ``rename`` then rewrites it where the
    reference's layout differs structurally.  Every shape is checked; with
    ``strict``, a port key missing from the checkpoint raises, otherwise it
    is left out (the module keeps its value)."""
    out, missing = {}, []
    for key, target in module.state_dict().items():
        tk = _source_key(key, prefix, rename)
        if tk not in state_dict:
            missing.append(tk)
            continue
        out[key] = _fit(tk, _tensor(state_dict[tk]), tuple(target.shape))
    if strict and missing:
        raise KeyError(f"missing checkpoint keys ({len(missing)}): {missing[:10]} ...")
    return out


def unused_torch_keys(state_dict, module: nn.Module, *, prefix: str = "",
                      rename=None) -> list:
    """Diagnostic: checkpoint keys no port key consumes."""
    consumed = {_source_key(k, prefix, rename) for k in module.state_dict()}
    return [k for k in state_dict if k not in consumed]


@torch.no_grad()
def load_state_dict(module: nn.Module, state_dict: Mapping[str, object], *,
                    prefix: str = "", rename=None, strict: bool = True) -> nn.Module:
    """Copy the converted ``state_dict`` into ``module`` in place, keeping
    each parameter's device, dtype and memory format."""
    sd = convert_state_dict(state_dict, module, prefix=prefix, rename=rename,
                            strict=strict)
    own = module.state_dict()
    for key, value in sd.items():
        own[key].copy_(value)
    return module
