"""The device mesh of the port: the counterpart of the mesh half of
``kandinsky2_tpu/parallel/mesh.py`` that spatial and data parallelism need.

JAX runs a ``shard_map`` in one process over a ``jax.sharding.Mesh``; the
port runs one process per shard, joined by a ``torch.distributed`` process
group.  :class:`Mesh` names that group's axes, and :meth:`Mesh.axis` hands
out the :class:`MeshAxis` that the collectives and the sharded modules
take where JAX takes an axis name.  Two forms:

* one axis, ``Mesh(group)`` (``"sp"`` for the row shards, as the JAX tests'
  ``Mesh(devices, ("sp",))``): every rank of the group one shard;
* two axes, ``Mesh(group, ("data", "sp"), shape=(d, s))``: the ``(data,
  sp)`` mesh of ``make_spdp_train_fn`` and ``train_unclip(mesh_shape=)``,
  the group's ranks laid out row-major as JAX's ``devs.reshape(d, s)``,
  with one sub-group for each row (an ``sp`` axis) and each column (a
  ``data`` axis).  Making a group is collective: every rank of the default
  group builds the same mesh, in the same order.

Every rank of the group builds the same mesh and calls the same entry point
with the same arguments.

The tensor-parallel and FSDP half of the JAX module (``make_mesh``,
``shard_params``, ``audit_sharding``, ``fsdp_state_shardings``,
``shard_pipeline``) is not ported yet; only its axis names are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class MeshAxis:
    """One named axis of a :class:`Mesh` as this rank sees it: the process
    group, its size, this rank's index along it, the global ranks in axis
    order and the group's backend ("gloo" or "nccl")."""

    name: str
    group: object
    size: int
    index: int
    ranks: tuple
    backend: str


class Mesh:
    """A mesh over a process group (the default group where ``group`` is
    None): one axis, every rank of the group one shard, or two axes of
    ``shape`` (see the module docstring)."""

    def __init__(self, group=None, axis_names: Sequence[str] = ("sp",),
                 shape: Optional[Sequence[int]] = None):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs torch.distributed.init_process_group "
                               "first (one process per shard)")
        self.group = dist.group.WORLD if group is None else group
        self.axis_names = tuple(axis_names)
        n = dist.get_world_size(self.group)
        ranks = tuple(dist.get_global_rank(self.group, i) for i in range(n))
        backend = str(dist.get_backend(self.group))
        if len(self.axis_names) == 1:
            if shape is not None and tuple(shape) != (n,):
                raise ValueError(f"mesh shape {tuple(shape)} over a group of {n} ranks")
            self._axes = {self.axis_names[0]: MeshAxis(
                self.axis_names[0], self.group, n, dist.get_rank(self.group), ranks,
                backend)}
            return
        if len(self.axis_names) != 2 or shape is None or len(shape) != 2:
            raise ValueError("the port's mesh has one axis, or two with their shape; "
                             f"got {self.axis_names} and shape {shape}")
        rows, cols = (int(v) for v in shape)
        if rows * cols != n:
            raise ValueError(f"mesh shape {(rows, cols)} needs {rows * cols} ranks; "
                             f"the group has {n}")
        me = dist.get_rank(self.group)
        r, c = divmod(me, cols)
        # every rank makes every sub-group, in one order (groups are collective)
        row_groups = [ranks[i * cols:(i + 1) * cols] for i in range(rows)]
        col_groups = [ranks[j::cols] for j in range(cols)]
        made = {g: dist.new_group(list(g)) for g in row_groups + col_groups}
        first, second = self.axis_names
        self._axes = {
            first: MeshAxis(first, made[col_groups[c]], rows, r, col_groups[c], backend),
            second: MeshAxis(second, made[row_groups[r]], cols, c, row_groups[r], backend),
        }

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return {name: ax.size for name, ax in self._axes.items()}

    def axis(self, name: Optional[str] = None) -> MeshAxis:
        """The axis ``name`` (None: the only axis of a one-axis mesh)."""
        if name is None:
            if len(self._axes) != 1:
                raise ValueError(f"name one of the mesh's axes {self.axis_names}")
            name = self.axis_names[0]
        if name not in self._axes:
            raise ValueError(f"mesh has no axis {name!r} (axes {self.axis_names})")
        return self._axes[name]


def axis_size(axis: MeshAxis) -> int:
    """``jax.lax.axis_size``: the number of shards along ``axis``."""
    return axis.size


def axis_index(axis: MeshAxis) -> int:
    """``jax.lax.axis_index``: this rank's shard along ``axis``."""
    return axis.index
