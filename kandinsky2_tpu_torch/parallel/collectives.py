"""The collectives of spatial and data parallelism over a
:class:`~.mesh.MeshAxis`: ``ppermute`` (edge rows, ring blocks), ``psum``,
``pmean`` and a tiled ``all_gather``, the counterparts of
``jax.lax.ppermute``, ``psum``, ``pmean`` and ``all_gather``, and
``pmean_grads``, the gradient all-reduce of a train step.

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

Autograd: each collective is differentiable, its backward the transpose of
its forward as JAX transposes it inside ``shard_map(check_vma=False)``:
a permutation's is the reverse permutation, ``psum``'s is ``psum`` and the
tiled ``all_gather``'s is a reduce-scatter (the sum over the ranks, then
this rank's slice: NCCL's own reduce-scatter, on gloo an ``all_reduce``
then the slice).  So where every rank seeds its own copy of a replicated
loss, a rank's parameter gradient is its share of the sum over the ranks,
and ``pmean_grads`` over the axis gives the gradient of the loss
(``kandinsky2_tpu/train/train_unclip.py:237-246``).  With grad mode off,
or no input that needs a gradient, a collective runs directly, with no
autograd node.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from .mesh import MeshAxis

# what gloo carries as CUDA tensors (see the module docstring)
GLOO_CUDA_COLLECTIVES = frozenset({"all_reduce", "broadcast", "all_gather"})
# the flat buckets of ``pmean_grads``: each is staged whole by gloo
GRAD_BUCKET_BYTES = 256 * 2**20


def _staged(axis: MeshAxis, t: torch.Tensor, collective: str) -> bool:
    return (axis.backend == "gloo" and t.is_cuda
            and collective not in GLOO_CUDA_COLLECTIVES)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _needs_graph(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def exchange(axis: MeshAxis, sends: Sequence, recvs: Sequence) -> None:
    """Point-to-point transfers along ``axis`` in one batch: ``sends`` are
    (tensor, destination index), ``recvs`` (tensor to fill, source index).
    The i-th send to a rank pairs with that rank's i-th receive from this
    one (each pair of ranks numbers its messages with a tag).  Not
    differentiable: ``ppermute_many`` is."""
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


def _permute(axis: MeshAxis, perms, xs):
    """Each x of ``xs`` through its permutation of ``perms``, all in one
    batch of transfers; a rank that a permutation does not target gets
    zeros."""
    me = axis.index
    outs = [torch.zeros(x.shape, dtype=x.dtype, device=x.device) for x in xs]
    sends, recvs = [], []
    for x, out, perm in zip(xs, outs, perms):
        sends += [(x, d) for s, d in perm if s == me]
        recvs += [(out, s) for s, d in perm if d == me]
    exchange(axis, sends, recvs)
    return outs


class _Permute(torch.autograd.Function):
    """``ppermute_many`` with its transpose: the reverse permutations."""

    @staticmethod
    def forward(ctx, axis, perms, *xs):
        ctx.axis, ctx.perms = axis, perms
        return tuple(_permute(axis, perms, xs))

    @staticmethod
    def backward(ctx, *gs):
        back = [[(d, s) for s, d in perm] for perm in ctx.perms]
        return (None, None, *_permute(ctx.axis, back, [g.contiguous() for g in gs]))


def ppermute_many(xs: Sequence[torch.Tensor], axis: MeshAxis, perms) -> list:
    """``jax.lax.ppermute`` of each x of ``xs`` by its permutation of
    ``perms`` (lists of (source, destination) pairs), in one batch of
    transfers; differentiable."""
    perms = tuple(tuple(tuple(p) for p in perm) for perm in perms)
    if _needs_graph(*xs):
        return list(_Permute.apply(axis, perms, *xs))
    return _permute(axis, perms, xs)


def ppermute(x: torch.Tensor, axis: MeshAxis, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: each (source, destination) pair of ``perm``
    sends the source's ``x`` to the destination; a rank that no pair
    targets gets zeros."""
    return ppermute_many([x], axis, [perm])[0]


def _all_reduce_(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Sum contiguous ``t`` over the axis in place."""
    if axis.size > 1:
        staged = _staged(axis, t, "all_reduce")
        buf = _to_host(t) if staged else t
        dist.all_reduce(buf, group=axis.group)
        if staged:
            t.copy_(buf)
    return t


def _psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    return _all_reduce_(x.clone(memory_format=torch.contiguous_format), axis)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.axis), None


def psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``jax.lax.psum``: the sum of ``x`` over the axis, on every rank;
    its backward is ``psum`` of the gradient."""
    return _Psum.apply(x, axis) if _needs_graph(x) else _psum(x, axis)


def pmean(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``jax.lax.pmean``: ``psum`` over the axis size."""
    return psum(x, axis) / axis.size


def _all_gather(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    x = x.contiguous()
    staged = _staged(axis, x, "all_gather")
    src = _to_host(x) if staged else x
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def _reduce_scatter(g: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """The sum of ``g`` over the axis, this rank's slice of ``dim``."""
    if axis.backend == "nccl":
        parts = [c.contiguous() for c in g.chunk(axis.size, dim=dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=axis.group)
        return out
    return _psum(g, axis).chunk(axis.size, dim=dim)[axis.index].contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axis, ctx.dim), None, None


def all_gather(x: torch.Tensor, axis: MeshAxis, dim: int = 0) -> torch.Tensor:
    """``jax.lax.all_gather(..., axis=dim, tiled=True)``: every rank's
    ``x`` concatenated along ``dim`` in axis order, on every rank; its
    backward is a reduce-scatter."""
    if axis.size == 1:
        return x
    if _needs_graph(x):
        return _AllGather.apply(x, axis, dim)
    return _all_gather(x, axis, dim)


def pmean_grads(params, axis: MeshAxis) -> None:
    """Replace each ``.grad`` of ``params`` (those that have one) by its
    mean over ``axis``, in place: the gradients are packed into flat
    buckets of at most ``GRAD_BUCKET_BYTES`` (a tensor larger than that is
    a bucket of its own), one ``all_reduce`` a bucket, so a rank never
    stages more than a bucket's bytes at once on gloo.  Every rank gets the
    same bits."""
    if axis.size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    bucket, nbytes = [], 0
    for g in grads + [None]:
        size = 0 if g is None else g.numel() * g.element_size()
        if bucket and (g is None or nbytes + size > GRAD_BUCKET_BYTES
                       or g.dtype != bucket[0].dtype or g.device != bucket[0].device):
            flat = _all_reduce_(torch.cat([b.reshape(-1) for b in bucket]), axis)
            flat /= axis.size
            for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(part.view_as(b))
            del flat
            bucket, nbytes = [], 0
        if g is not None:
            bucket.append(g)
            nbytes += size
