"""JAX parameter tree -> state_dict of the PyTorch port.

The inverse of ``kandinsky2_tpu/weights/convert.py`` (``_transform`` and
``torch_key_for``).  The flax modules and the port's modules both carry the
reference state_dict names, so a flax path maps to a key mechanically:

    a/b/c + "kernel" | "scale" | "embedding"  ->  "a.b.c.weight"
    a/b/c + "bias"                            ->  "a.b.c.bias"
    a/b   + any other leaf                    ->  "a.b.<leaf>"

with the layout transforms

    conv kernel  HWIO -> OIHW
    Dense kernel IO   -> OI (or OI11 / OI1 where the port's module is a
                         1x1 conv)
    anything else unchanged.

Every JAX leaf must land on a port key of the transposed shape and every
port key must be filled; anything else raises.  The mapping needs no
per-model table: it serves every port model, the inpainting UNet
(``InpaintText2ImUNet21``, whose ``input_blocks.0.0`` conv takes 2C + 1 = 9
channels) among them.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

WEIGHT_LEAVES = ("kernel", "scale", "embedding")


def torch_key_for(path: tuple) -> str:
    """Map a flax param path (tuple of names, leaf last) to a torch key."""
    *parents, leaf = path
    if leaf in WEIGHT_LEAVES:
        return ".".join(parents + ["weight"])
    if leaf == "bias":
        return ".".join(parents + ["bias"])
    return ".".join(list(parents) + [leaf])


def flatten(tree: Mapping, prefix: tuple = ()) -> dict:
    """Nested dict of arrays -> {path tuple: array}."""
    out = {}
    for name, node in tree.items():
        path = prefix + (str(name),)
        if isinstance(node, Mapping):
            out.update(flatten(node, path))
        else:
            out[path] = node
    return out


def _layout(leaf: str, jax_shape: tuple, torch_shape: tuple) -> str:
    """The transform taking a JAX leaf of ``jax_shape`` to ``torch_shape``."""
    if leaf == "kernel" and len(jax_shape) == 4:
        op, shape = "hwio", tuple(jax_shape[i] for i in (3, 2, 0, 1))
    elif leaf == "kernel" and len(jax_shape) == 2:
        o, i = jax_shape[1], jax_shape[0]
        op, shape = {2: ("io", (o, i)), 3: ("io1", (o, i, 1)),
                     4: ("io11", (o, i, 1, 1))}.get(len(torch_shape), ("io", (o, i)))
    else:
        op, shape = "id", tuple(jax_shape)
    if shape != tuple(torch_shape):
        raise ValueError(
            f"shape mismatch for {leaf}: jax {tuple(jax_shape)} maps to "
            f"{shape}, port has {tuple(torch_shape)}"
        )
    return op


def _apply(op: str, a: np.ndarray) -> np.ndarray:
    if op == "hwio":
        return a.transpose(3, 2, 0, 1)
    if op == "io":
        return a.T
    if op == "io1":
        return a.T[:, :, None]
    if op == "io11":
        return a.T[:, :, None, None]
    return a


def plan(jax_tree: Mapping, target_shapes: Mapping[str, tuple]) -> dict:
    """{torch key: (jax path, transform)} for every leaf, checked against the
    port's ``target_shapes`` ({key: shape}).  Raises on an unmatched or
    mis-shaped key."""
    out = {}
    unmatched = []
    for path, arr in flatten(jax_tree).items():
        key = torch_key_for(path)
        if key not in target_shapes:
            unmatched.append(key)
            continue
        out[key] = (path, _layout(path[-1], tuple(arr.shape),
                                  tuple(target_shapes[key])))
    if unmatched:
        raise KeyError(f"JAX leaves with no port key ({len(unmatched)}): "
                       f"{sorted(unmatched)[:10]}")
    missing = sorted(set(target_shapes) - set(out))
    if missing:
        raise KeyError(f"port keys with no JAX leaf ({len(missing)}): {missing[:10]}")
    return out


def jax_to_state_dict(jax_tree: Mapping, module: torch.nn.Module) -> dict:
    """The port state_dict of ``module`` filled from ``jax_tree`` (numpy or
    JAX arrays), as float32 CPU tensors."""
    target = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    flat = flatten(jax_tree)
    return {
        key: torch.from_numpy(np.ascontiguousarray(
            _apply(op, np.array(flat[path], dtype=np.float32))))
        for key, (path, op) in plan(jax_tree, target).items()
    }


def lora_from_jax(jax_loras: Mapping) -> dict:
    """The JAX package's LoRA factors ({path tuple: {"down", "up"}}) on the
    port's keys ({weight name: {"down", "up"}}), as float32 CPU tensors in
    the same [in, r] and [r, out] layouts (``models/lora.py``)."""
    return {
        torch_key_for(tuple(path)): {
            k: torch.from_numpy(np.array(f[k], dtype=np.float32)) for k in ("down", "up")
        }
        for path, f in jax_loras.items()
    }


def lpips_from_jax(jax_params: Mapping) -> dict:
    """The JAX package's LPIPS parameters ({"features.K": {"kernel" HWIO,
    "bias"}, "lin{i}": {"weight"}}) as the port's ({"features.K.weight"
    OIHW, "features.K.bias", "lin{i}.weight"}), float32 CPU tensors."""
    return {
        torch_key_for(path): torch.from_numpy(np.ascontiguousarray(
            _apply("hwio" if path[-1] == "kernel" else "id",
                   np.array(arr, dtype=np.float32))))
        for path, arr in flatten(jax_params).items()
    }


def load_jax_params(module: torch.nn.Module, jax_tree: Mapping) -> torch.nn.Module:
    """Copy ``jax_tree`` into ``module`` in place, keeping each parameter's
    device and dtype."""
    sd = jax_to_state_dict(jax_tree, module)
    with torch.no_grad():
        for key, param in module.state_dict().items():
            param.copy_(sd[key])
    return module
