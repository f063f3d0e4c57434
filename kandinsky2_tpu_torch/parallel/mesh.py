"""The device mesh of the port: the counterpart of the mesh half of
``kandinsky2_tpu/parallel/mesh.py`` that spatial parallelism needs.

JAX runs a ``shard_map`` in one process over a ``jax.sharding.Mesh``; the
port runs one process per shard, joined by a ``torch.distributed`` process
group.  :class:`Mesh` names that group's one axis (``"sp"`` for the row
shards, as the JAX tests' ``Mesh(devices, ("sp",))``), and
:meth:`Mesh.axis` hands out the :class:`MeshAxis` that the collectives and
the sharded modules take where JAX takes an axis name.  Every rank of the
group builds the same mesh and calls the same entry point with the same
arguments.

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
    """A one-axis mesh over a process group (the default group where
    ``group`` is None), every rank of the group one shard."""

    def __init__(self, group=None, axis_names: Sequence[str] = ("sp",)):
        if len(axis_names) != 1:
            raise ValueError("the port's mesh has one axis; got "
                             f"{tuple(axis_names)}")
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs torch.distributed.init_process_group "
                               "first (one process per shard)")
        self.group = dist.group.WORLD if group is None else group
        self.axis_names = tuple(axis_names)
        n = dist.get_world_size(self.group)
        self._axis = MeshAxis(
            name=self.axis_names[0], group=self.group, size=n,
            index=dist.get_rank(self.group),
            ranks=tuple(dist.get_global_rank(self.group, i) for i in range(n)),
            backend=str(dist.get_backend(self.group)))

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return {self._axis.name: self._axis.size}

    def axis(self, name: Optional[str] = None) -> MeshAxis:
        name = self.axis_names[0] if name is None else name
        if name != self._axis.name:
            raise ValueError(f"mesh has no axis {name!r} (axes {self.axis_names})")
        return self._axis


def axis_size(axis: MeshAxis) -> int:
    """``jax.lax.axis_size``: the number of shards along ``axis``."""
    return axis.size


def axis_index(axis: MeshAxis) -> int:
    """``jax.lax.axis_index``: this rank's shard along ``axis``."""
    return axis.index
