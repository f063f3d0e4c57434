"""LoRA adapters as weight transforms, the counterpart of
``kandinsky2_tpu/models/lora.py``.

The reference applies rank-4 LoRA attention processors to the 2.2 decoder
through diffusers (notebooks/lora_decoder.ipynb).  Here the adapters are
(down, up) factor pairs keyed by the target weight's state_dict name, in
the JAX package's layout and scaling: ``down`` [in, r], ``up`` [r, out],
so the weight change of a ``Linear`` (whose weight is [out, in]) is
(down @ up)ᵀ.  ``merge_lora`` folds W + scale·(down @ up)ᵀ into a
{name: tensor} dict that ``torch.func.functional_call`` runs the module
on, so one module serves the base, the merged weights, a teacher and a
student; ``unmerge_lora`` takes the change back out.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch
from torch import nn

TARGETS = ("to_q", "to_k", "to_v", "add_k_proj", "add_v_proj", "to_out.0", "qkv",
           "proj_out", "attn1.")


def default_target(name: str, tensor: torch.Tensor) -> bool:
    """The attention projections (diffusers LoRAAttnAddedKVProcessor touches
    to_q/to_k/to_v/add_k/add_v/to_out), by the JAX package's substrings
    on the dotted name of a ``Linear``'s weight."""
    return name.endswith(".weight") and any(m in name for m in TARGETS)


def init_lora(module: nn.Module, generator: torch.Generator, rank: int = 4,
              target: Callable[[str, torch.Tensor], bool] = default_target
              ) -> Dict[str, dict]:
    """{name: {"down": [in, r], "up": [r, out]}} in fp32 for the 2-D weight
    of every ``Linear`` that ``target`` selects: ``down`` ~ N(0, 1)/√in,
    ``up`` = 0, so the merged weights start as the base.  The draws come
    from ``generator``, in the order of ``named_modules``."""
    loras = {}
    for mname, mod in module.named_modules():
        if not isinstance(mod, nn.Linear):
            continue
        name = f"{mname}.weight"
        w = mod.weight
        if w.dim() != 2 or not target(name, w):
            continue
        if hasattr(w, "tp_shard"):
            raise ValueError(f"init_lora: {name} is tensor-parallel sharded; draw the "
                             "factors on the unsharded module")
        out_f, in_f = w.shape
        down = torch.randn((in_f, rank), generator=generator, device=w.device)
        loras[name] = {"down": down / in_f ** 0.5,
                       "up": torch.zeros((rank, out_f), device=w.device)}
    return loras


def merge_lora(params: Mapping[str, torch.Tensor], loras: Mapping[str, dict],
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """A new {name: tensor} dict: ``params`` with W + scale·(down @ up)ᵀ in
    place of every factored weight, computed in fp32 and cast to W's dtype
    (differentiable in the factors).  Raises where the factors do not
    make W's shape: a tensor-parallel shard takes its slice of the factors
    (``parallel.tensor_parallel.local_lora``)."""
    out = dict(params)
    for name, f in loras.items():
        w = out[name]
        delta = (f["down"].float() @ f["up"].float()).t()
        if delta.shape != w.shape:
            raise ValueError(f"merge_lora: the factors of {name} make "
                             f"{tuple(delta.shape)}, the weight is {tuple(w.shape)}")
        out[name] = (w.float() + scale * delta).to(w.dtype)
    return out


def unmerge_lora(params: Mapping[str, torch.Tensor], loras: Mapping[str, dict],
                 scale: float = 1.0) -> Dict[str, torch.Tensor]:
    return merge_lora(params, loras, -scale)
