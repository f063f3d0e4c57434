"""The collectives of spatial parallelism over a :class:`~.mesh.MeshAxis`:
``ppermute`` (edge rows, ring blocks), ``psum`` and a tiled ``all_gather``,
the counterparts of ``jax.lax.ppermute``, ``psum`` and ``all_gather``.

Backends:

* NCCL: each rank owns a card, and every tensor crosses as it is.
* gloo: how several ranks share one card (NCCL refuses two ranks on one
  device), and how the CPU tests run.  Gloo carries CPU tensors for every
  collective, and CUDA tensors for ``all_reduce``, ``broadcast`` (torch's
  backend table) and ``all_gather`` (found on the H100's machine with
  torch 2.11: ``chip_smoke.py`` phase 20a probes it), not for send and
  receive.  A CUDA tensor bound for a gloo point-to-point transfer is
  staged through pinned host memory here, by backend, and copied back to
  the card; the rank's tensors otherwise stay on the card.

No autograd: the sharded paths are inference only (sp training is a later
slice of the port).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from .mesh import MeshAxis

# what gloo carries as CUDA tensors (see the module docstring)
GLOO_CUDA_COLLECTIVES = frozenset({"all_reduce", "broadcast", "all_gather"})


def _staged(axis: MeshAxis, t: torch.Tensor, collective: str) -> bool:
    return (axis.backend == "gloo" and t.is_cuda
            and collective not in GLOO_CUDA_COLLECTIVES)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def exchange(axis: MeshAxis, sends: Sequence, recvs: Sequence) -> None:
    """Point-to-point transfers along ``axis`` in one batch: ``sends`` are
    (tensor, destination index), ``recvs`` (tensor to fill, source index).
    The i-th send to a rank pairs with that rank's i-th receive from this
    one (each pair of ranks numbers its messages with a tag)."""
    if not sends and not recvs:
        return
    staged = [_staged(axis, t, "send") for t, _ in list(sends) + list(recvs)]
    ops, fills, tags = [], [], {}
    for (t, dst), stage in zip(sends, staged):
        tag = tags[("s", dst)] = tags.get(("s", dst), -1) + 1
        buf = _to_host(t) if stage else t.contiguous()
        ops.append(dist.P2POp(dist.isend, buf, axis.ranks[dst], axis.group, tag))
    for (t, src), stage in zip(recvs, staged[len(sends):]):
        tag = tags[("r", src)] = tags.get(("r", src), -1) + 1
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if stage else t
        if not stage and not t.is_contiguous():
            raise ValueError("exchange: receive buffers must be contiguous")
        ops.append(dist.P2POp(dist.irecv, buf, axis.ranks[src], axis.group, tag))
        if stage:
            fills.append((t, buf))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for t, buf in fills:
        t.copy_(buf)


def ppermute(x: torch.Tensor, axis: MeshAxis, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: each (source, destination) pair of ``perm``
    sends the source's ``x`` to the destination; a rank that no pair
    targets gets zeros."""
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    me = axis.index
    exchange(axis, [(x, d) for s, d in perm if s == me],
             [(out, s) for s, d in perm if d == me])
    return out


def psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``jax.lax.psum``: the sum of ``x`` over the axis, on every rank."""
    out = x.clone()
    if axis.size > 1:
        staged = _staged(axis, out, "all_reduce")
        buf = _to_host(out) if staged else out
        dist.all_reduce(buf, group=axis.group)
        if staged:
            out.copy_(buf)
    return out


def all_gather(x: torch.Tensor, axis: MeshAxis, dim: int = 0) -> torch.Tensor:
    """``jax.lax.all_gather(..., axis=dim, tiled=True)``: every rank's
    ``x`` concatenated along ``dim`` in axis order, on every rank."""
    if axis.size == 1:
        return x
    x = x.contiguous()
    staged = _staged(axis, x, "all_gather")
    src = _to_host(x) if staged else x
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out
