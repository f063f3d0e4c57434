"""The sharded forms of the layers through which every parameter that the
tensor-parallel rule shards passes (``models/layers.Linear``,
``models/layers.Conv2d`` and ``nn.Embedding``): what XLA makes of JAX's
placement (``kandinsky2_tpu/parallel/mesh.py`` ``shard_params``), written
out over a ``torch.distributed`` model axis.

* **Column-parallel** (output features sharded): the rank's product with
  its slice of the weight (and of the bias), then the tiled
  ``all_gather`` on the last axis, which for the NHWC activations of a
  convolution is the channels.
* **Row-parallel** (input features sharded): the rank's slice of the input
  features times its slice of the weight, in fp32 (a bf16 product would
  round each rank's partial sum before the sum), ``psum`` over the model
  axis, the bias added once after the sum, then one rounding to the
  compute dtype.
* **Embedding** sharded on its features: the local lookup, then the
  gather; on its rows (the vocabulary): the rows this rank holds, zeros
  elsewhere, then ``psum``.

Every sharded layer takes the full input and returns the full output.
JAX's rule is not Megatron-paired (at the 2.1 UNet's ds2 level ``qkv`` is
column-sharded while ``proj_out`` stays whole), so no layer may assume
what its neighbour did.

:func:`shard_layer_` turns a layer into its sharded form in place: the
weight keeps only this rank's slice (a new tensor, so the full one is
freed; channels-last for a convolution), the bias stays whole, and the
weight records its cut as ``weight.tp_shard`` = (dim, index, size) for
the code that reads weights outside ``forward`` (:func:`full_weight`,
:func:`local_lora`).  The collectives the sharded layers launch are
counted (:func:`collective_counts`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv2d, Linear
from .collectives import all_gather, psum
from .mesh import MeshAxis

_COUNTS = {"all_gather": 0, "psum": 0}


def collective_counts() -> dict:
    """{collective: calls} made by sharded layers since the last reset."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def _gather(x: torch.Tensor, axis: MeshAxis, dim: int = -1) -> torch.Tensor:
    _COUNTS["all_gather"] += 1
    return all_gather(x, axis, dim=dim)


def _sum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    _COUNTS["psum"] += 1
    return psum(x, axis)


class ColumnLinear(Linear):
    """``Linear`` with its output features sharded."""

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias[self.tp_slice].to(dt)
        return _gather(F.linear(x.to(dt), self.weight.to(dt), b), self.tp_axis)


class RowLinear(Linear):
    """``Linear`` with its input features sharded."""

    def forward(self, x):
        dt = self.compute_dtype
        part = F.linear(x[..., self.tp_slice].to(dt).float(), self.weight.to(dt).float())
        y = _sum(part, self.tp_axis)
        if self.bias is not None:
            y = y + self.bias.to(dt).float()
        return y.to(dt)


class ColumnConv2d(Conv2d):
    """``Conv2d`` (NHWC) with its output channels sharded."""

    def forward(self, x, padding=None):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias[self.tp_slice].to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), b, self.stride,
                     self.padding if padding is None else padding)
        return _gather(y.permute(0, 2, 3, 1), self.tp_axis)


class RowConv2d(Conv2d):
    """``Conv2d`` (NHWC) with its input channels sharded."""

    def forward(self, x, padding=None):
        dt = self.compute_dtype
        xs = x[..., self.tp_slice].to(dt).float().permute(0, 3, 1, 2)
        y = F.conv2d(xs, self.weight.to(dt).float(), None, self.stride,
                     self.padding if padding is None else padding)
        y = _sum(y.permute(0, 2, 3, 1), self.tp_axis)
        if self.bias is not None:
            y = y + self.bias.to(dt).float()
        return y.to(dt)


class ColumnEmbedding(nn.Embedding):
    """``nn.Embedding`` with its features sharded."""

    def forward(self, ids):
        y = F.embedding(ids, self.weight, None, self.max_norm, self.norm_type,
                        self.scale_grad_by_freq, self.sparse)
        return _gather(y, self.tp_axis)


class RowEmbedding(nn.Embedding):
    """``nn.Embedding`` with its rows (the vocabulary) sharded."""

    def forward(self, ids):
        lo, k = self.tp_slice.start, self.weight.shape[0]
        inside = (ids >= lo) & (ids < lo + k)
        y = F.embedding(torch.where(inside, ids - lo, 0), self.weight, None,
                        self.max_norm, self.norm_type, self.scale_grad_by_freq,
                        self.sparse)
        return _sum(y * inside[..., None].to(y.dtype), self.tp_axis)


# (layer type, sharded torch dim of its weight) -> its sharded form
_FORMS = {(Linear, 0): ColumnLinear, (Linear, 1): RowLinear,
          (Conv2d, 0): ColumnConv2d, (Conv2d, 1): RowConv2d,
          (nn.Embedding, 1): ColumnEmbedding, (nn.Embedding, 0): RowEmbedding}


def shard_layer_(module: nn.Module, dim: int, axis: MeshAxis, name: str = "") -> None:
    """Turn ``module`` into its sharded form over ``axis`` in place, its
    weight cut on torch dim ``dim`` (see the module docstring).  Raises for
    a layer type or dim with no sharded form, and for a cut that the axis
    does not divide."""
    form = _FORMS.get((type(module), dim))
    if form is None:
        raise TypeError(f"{name or type(module).__name__}: no sharded form of a "
                        f"{type(module).__name__} cut on dim {dim}")
    w = module.weight
    if w.shape[dim] % axis.size:
        raise ValueError(f"{name}: {axis.size} ranks do not divide dim {dim} of "
                         f"{tuple(w.shape)}")
    k = w.shape[dim] // axis.size
    fmt = torch.channels_last if w.dim() == 4 else torch.contiguous_format
    with torch.no_grad():
        w.data = w.data.narrow(dim, axis.index * k, k).clone(memory_format=fmt)
    w.tp_shard = (dim, axis.index, axis.size)
    module.tp_axis = axis
    module.tp_slice = slice(axis.index * k, (axis.index + 1) * k)
    module.__class__ = form


def is_sharded(module: nn.Module) -> bool:
    return type(module) in _FORMS.values()


def full_weight(module: nn.Module) -> torch.Tensor:
    """``module.weight`` whole: gathered over the model axis where the
    layer is sharded (for code that reads a weight outside ``forward``)."""
    w = module.weight
    if not is_sharded(module):
        return w
    return _gather(w, module.tp_axis, dim=w.tp_shard[0])


def local_lora(weight: torch.Tensor, factors: dict) -> dict:
    """The LoRA factors ({"down": [in, r], "up": [r, out]}) of a ``Linear``
    weight [out, in], cut to this rank's slice of a sharded weight: the
    columns of ``up`` where the output features are sharded, the rows of
    ``down`` where the input features are, so ``(down @ up)ᵀ`` is this
    rank's slice of the whole weight's change."""
    shard = getattr(weight, "tp_shard", None)
    if shard is None:
        return factors
    dim, index, size = shard
    key, fdim = ("up", 1) if dim == 0 else ("down", 0)
    f = factors[key]
    k = f.shape[fdim] // size
    return dict(factors, **{key: f.narrow(fdim, index * k, k)})
