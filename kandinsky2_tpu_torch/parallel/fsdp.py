"""ZeRO-3 state sharding over the ``data`` axis of a :class:`~.mesh.Mesh`:
what XLA makes of JAX's ``fsdp_state_shardings`` placement
(``kandinsky2_tpu/train/train_unclip.py`` ``make_fsdp_train_fn``), written
out over ``torch.distributed``.

* **The slices.** :func:`shard_state_` keeps, of every parameter that the
  placement (``mesh.fsdp_state_shardings``) cuts over ``data``, only this
  rank's slice (a new tensor; the whole one is freed).  The parameter keeps
  its name and stays an ``nn.Parameter`` of its module, so the freeze
  masks, the optimizer, the EMA dict and ``state_dict`` keys see the same
  names; it records its cut as ``param.fsdp_shard`` = (dim, index, size), as
  ``tensor_parallel.shard_layer_`` records ``tp_shard``, and every cut made
  on it, tensor-parallel ones included, as ``param.mesh_cuts`` = ((dim,
  MeshAxis), ...), in the order they were made.  The optimizer and the EMA
  built on the sliced parameters hold slices too.
* **The gathers, by unit.** A unit is one top-level block of the UNet (each
  ``input_blocks[i]``, the middle block, each ``output_blocks[i]``) or the
  rest of the model.  When a unit's first layer is called, its sliced
  parameters are packed into one flat buffer per dtype and all-gathered in
  one call; each whole tensor is rebuilt along its own cut dim and stands
  in the module's place of the slice until the unit's last layer returns.
  ``remat`` (``torch.utils.checkpoint``) gathers again in its
  recomputation.  Frozen parameters are gathered with no graph.
* **The gradient.** The gather's backward is a reduce-scatter of the unit's
  trainable gradients in one flat buffer (NCCL's own; on gloo an
  ``all_reduce`` then the slice), so each slice's ``.grad`` is the sum over
  the ranks of their local gradients.  :func:`reduce_grads` scales the
  step's gradients to the gradient of the whole batch's mean loss.
* **Whole-state gather and place.** :func:`gather_state` gathers the whole
  train state into the unsharded ``TrainState.state_dict()`` format (on
  the host; collective), :func:`place_state` loads such a dict into a
  sharded state (each rank its slices), so a state saved sharded resumes
  unsharded and the reverse.

The collectives are counted (:func:`collective_counts`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .collectives import GRAD_BUCKET_BYTES, _all_gather, _reduce_scatter, pmean_grads
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, MeshAxis, P, _named_params

_COUNTS = {"all_gather": 0, "reduce_scatter": 0}


def collective_counts() -> dict:
    """{collective: calls} made by the unit gathers and their backwards
    since the last reset."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def cuts(t: torch.Tensor) -> tuple:
    """((torch dim, MeshAxis), ...): the cuts made on a parameter, in order."""
    return getattr(t, "mesh_cuts", ())


def full_shape(p: torch.Tensor) -> tuple:
    """The whole shape of a parameter that holds a slice (``mesh_cuts``, or
    ``tp_shard`` of ``shard_params`` alone)."""
    shape = list(p.shape)
    if cuts(p):
        for d, ax in cuts(p):
            shape[d] *= ax.size
    elif getattr(p, "tp_shard", None) is not None:
        shape[p.tp_shard[0]] *= p.tp_shard[2]
    return tuple(shape)


def _fmt(t: torch.Tensor):
    return (torch.channels_last if t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def cut_(p: torch.Tensor, dim: int, axis: MeshAxis) -> None:
    """Keep this rank's slice of ``p`` along ``dim`` over ``axis``, in place
    (a new tensor in the same memory format; the whole one is freed), and
    record the cut."""
    if p.shape[dim] % axis.size:
        raise ValueError(f"{axis.size} ranks do not divide dim {dim} of {tuple(p.shape)}")
    k = p.shape[dim] // axis.size
    with torch.no_grad():
        p.data = p.data.narrow(dim, axis.index * k, k).clone(memory_format=_fmt(p.data))
    p.mesh_cuts = cuts(p) + ((dim, axis),)
    if axis.name == DATA_AXIS:
        p.fsdp_shard = (dim, axis.index, axis.size)


def _slice(t: torch.Tensor, made: Sequence) -> torch.Tensor:
    """This rank's slice of a whole tensor cut as ``made`` says (a copy)."""
    for d, ax in made:
        k = t.shape[d] // ax.size
        t = t.narrow(d, ax.index * k, k)
    return t.clone() if made else t


# --- flat gathers and reduce-scatters --------------------------------------------------


def _to_whole(pieces: torch.Tensor, dim: int) -> torch.Tensor:
    """[N, *slice] -> the whole tensor, the N slices laid along ``dim``."""
    shape = list(pieces.shape[1:])
    shape[dim] *= pieces.shape[0]
    return pieces.movedim(0, dim).reshape(shape)


def _to_pieces(whole: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """The inverse of :func:`_to_whole`: [N, *slice]."""
    shape = list(whole.shape)
    shape[dim: dim + 1] = [n, shape[dim] // n]
    return whole.reshape(shape).movedim(dim, 0)


def _gather_flat(slices: Sequence[torch.Tensor], dims: Sequence[int],
                 axis: MeshAxis) -> list:
    """Every slice whole over ``axis`` (each along its own dim) through one
    ``all_gather`` of their flat concatenation (one dtype)."""
    _COUNTS["all_gather"] += 1
    flat = torch.cat([s.reshape(-1) for s in slices])
    parts = _all_gather(flat, axis, 0).view(axis.size, -1)
    out, off = [], 0
    for s, d in zip(slices, dims):
        n = s.numel()
        whole = _to_whole(parts[:, off:off + n].reshape(axis.size, *s.shape), d)
        out.append(whole.contiguous(memory_format=_fmt(s)))
        off += n
    return out


def _reduce_scatter_flat(grads: Sequence[torch.Tensor], dims: Sequence[int],
                         axis: MeshAxis) -> list:
    """Each whole gradient summed over ``axis`` and cut to this rank's slice,
    through one reduce-scatter of a flat buffer (one dtype)."""
    _COUNTS["reduce_scatter"] += 1
    n = axis.size
    rows = torch.cat([_to_pieces(g, d, n).reshape(n, -1) for g, d in zip(grads, dims)], 1)
    flat = _reduce_scatter(rows.reshape(-1), axis, 0)
    out, off = [], 0
    for g, d in zip(grads, dims):
        shape = list(g.shape)
        shape[d] //= n
        k = math.prod(shape)
        out.append(flat[off:off + k].view(shape))
        off += k
    return out


def _by_dtype(ts: Sequence[torch.Tensor], keep: Sequence[bool]) -> dict:
    groups = {}
    for i, (t, k) in enumerate(zip(ts, keep)):
        if k:
            groups.setdefault(t.dtype, []).append(i)
    return groups


class _GatherUnit(torch.autograd.Function):
    """A unit's slices whole (forward: one all-gather a dtype), and its
    trainable slices' gradients (backward: one reduce-scatter a dtype)."""

    @staticmethod
    def forward(ctx, unit, *slices):
        ctx.unit = unit
        ctx.set_materialize_grads(False)
        out = [None] * len(slices)
        for idx in _by_dtype(slices, [True] * len(slices)).values():
            wholes = _gather_flat([slices[i] for i in idx], [unit.dims[i] for i in idx],
                                  unit.axis)
            for i, w in zip(idx, wholes):
                out[i] = w
        ctx.mark_non_differentiable(*[w for w, need in zip(out, ctx.needs_input_grad[1:])
                                      if not need])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        unit = ctx.unit
        need = ctx.needs_input_grad[1:]
        out = [None] * len(grads)
        for idx in _by_dtype(unit.slices, need).values():
            zeros = lambda s: torch.zeros(full_shape(s), dtype=s.dtype, device=s.device)
            whole = [grads[i] if grads[i] is not None else zeros(unit.slices[i])
                     for i in idx]
            for i, g in zip(idx, _reduce_scatter_flat(whole, [unit.dims[i] for i in idx],
                                                      unit.axis)):
                out[i] = g
        return (None, *out)


class _Unit:
    """The sliced parameters of one unit: (module, name, parameter) slots."""

    def __init__(self, slots: list, axis: MeshAxis):
        self.slots, self.axis = slots, axis
        self.slices = [p for _, _, p in slots]
        self.dims = [p.fsdp_shard[0] for p in self.slices]

    def gather(self, *_):
        wholes = _GatherUnit.apply(self, *self.slices)
        for (module, name, _), w in zip(self.slots, wholes):
            module._parameters[name] = w

    def release(self, *_):
        for module, name, p in self.slots:
            module._parameters[name] = p


def _unit_layers(model: nn.Module) -> list:
    """The layer lists of the model's top-level blocks (none where the model
    has no UNet torso)."""
    if not all(hasattr(model, n) for n in ("input_blocks", "middle_block",
                                            "output_blocks")):
        return []
    return ([list(b) for b in model.input_blocks] + [list(model.middle_block)]
            + [list(b) for b in model.output_blocks])


def _install_units(model: nn.Module, axis: MeshAxis) -> None:
    """Hooks that gather each unit's sliced parameters around it: on a
    block's first layer (before) and last layer (after), and on the model
    itself for the parameters of no block."""

    def slots(modules):
        return [(m, n, p) for m in modules for n, p in m.named_parameters(recurse=False)
                if getattr(p, "fsdp_shard", None) is not None]

    units, seen = [], set()
    for layers in _unit_layers(model):
        mods = [m for layer in layers for m in layer.modules()]
        seen.update(id(m) for m in mods)
        units.append((layers[0], layers[-1], slots(mods)))
    units.append((model, model, slots(m for m in model.modules() if id(m) not in seen)))
    handles = []
    for first, last, unit_slots in units:
        if unit_slots:
            unit = _Unit(unit_slots, axis)
            handles.append(first.register_forward_pre_hook(unit.gather))
            handles.append(last.register_forward_hook(unit.release))
    model._fsdp_hooks = handles


# --- placing a state -------------------------------------------------------------------


def shard_state_(state, mesh: Mesh, specs: dict, axis: str = DATA_AXIS) -> None:
    """Keep only this rank's slice of each parameter of ``state``'s model
    that ``specs`` (``mesh.fsdp_state_shardings``) cuts over ``axis``, in
    place, and install the unit gathers on the model.  A spec's model-axis
    entries must be the cuts ``shard_params`` made already; they are
    recorded in ``mesh_cuts`` beside the data cut.  The optimizer must have
    no state yet: build it, its fp32 masters and the EMA on the slices
    (``make_fsdp_train_fn``'s ``init_fn`` does), so that they hold slices."""
    opt = getattr(state, "optimizer", None)
    if opt is not None and getattr(opt, "state", None):
        raise ValueError("shard_state_ places a state before its optimizer's first step; "
                         "load a saved state into a sharded one with place_state")
    model = state.model
    if hasattr(model, "_fsdp_hooks"):
        raise ValueError("the model is sharded already")
    data = mesh.axis(axis)
    for name, p, owner in _named_params(model):
        spec = list(specs["params"][name])
        tp = getattr(p, "tp_shard", None)
        tp_dims = [d for d, ax in enumerate(spec) if ax == MODEL_AXIS]
        if tp_dims != ([] if tp is None else [tp[0]]):
            raise ValueError(f"{name}: the placement cuts {tp_dims} on the model axis, "
                             f"shard_params cut {tp}: run shard_params with the same rule")
        if tp is not None:
            p.mesh_cuts = ((tp[0], owner.tp_axis),)
        for d, ax in enumerate(spec):
            if ax == axis:
                cut_(p, d, data)
    _install_units(model, data)


def reduce_grads(params: Sequence[torch.Tensor], axes: Sequence[MeshAxis]) -> None:
    """The gradients of a step on which every rank seeded its own copy of
    its loss, made the gradient of the whole batch's mean loss, in place.
    Over each axis: a parameter cut on it holds the sum over its ranks (the
    gather's reduce-scatter over ``data``; the column- and row-parallel
    layers' transposes over ``model``, which give each rank the model size
    times its slice's gradient), so it is divided by the axis size; a
    parameter whole on it holds a rank's partial gradient, so it is
    ``pmean``'d over it."""
    have = [p for p in params if p.grad is not None]
    for ax in axes:
        on = [any(a.name == ax.name for _, a in cuts(p)) for p in have]
        split = [p.grad for p, o in zip(have, on) if o]
        if split and ax.size > 1:
            torch._foreach_div_(split, ax.size)
        pmean_grads([p for p, o in zip(have, on) if not o], ax)


# --- the optimizer state's cuts ----------------------------------------------------------


def _live(optimizer) -> list:
    """The optimizer's parameters in ``state_dict`` index order (an fp32
    master optimizer's live parameters, whose masters it indexes so)."""
    live = getattr(optimizer, "live", None)
    return list(live) if live is not None else [p for g in optimizer.param_groups
                                                for p in g["params"]]


def _group_of(opt_sd: dict, i: int) -> dict:
    return next(g for g in opt_sd["param_groups"] if i in g["params"])


def _gone_dim(shape, key: str, ndim: int, group: dict) -> Optional[int]:
    """The dim of a parameter of whole ``shape`` that one ``ndim``-dim
    tensor of its optimizer state lacks: None where it has them all; an
    Adafactor row (``v_row``) or column (``v_col``) factor lacks the dim it
    reduces, decided on the whole shape.  Raises for any other tensor."""
    from ..train.optim import _factored_dims

    if ndim == len(shape):
        return None
    dims = None
    if key in ("v_row", "v_col") and "min_dim_size_to_factor" in group:
        dims = _factored_dims(tuple(shape), group["factored"],
                              group["min_dim_size_to_factor"])
    if dims is None or ndim != len(shape) - 1:
        raise ValueError(f"optimizer state {key!r} ({ndim} dims) of a parameter of "
                         f"shape {tuple(shape)}: no placement known")
    return dims[1] if key == "v_row" else dims[0]


def _state_cuts(p: torch.Tensor, key: str, ndim: int, group: dict) -> tuple:
    """The cuts of one tensor of ``p``'s optimizer state (none for a scalar)."""
    if ndim == 0 or not cuts(p):
        return ()
    gone = _gone_dim(full_shape(p), key, ndim, group)
    if gone is None:
        return cuts(p)
    return tuple((d - (d > gone), ax) for d, ax in cuts(p) if d != gone)


def optimizer_state_specs(optimizer, model: nn.Module, param_specs: dict) -> dict:
    """{parameter name: {state key: spec}} of the optimizer's state tensors
    as it holds them now (nothing before its first step), each from its
    parameter's spec."""
    names = {id(p): n for n, p in model.named_parameters()}
    sd = optimizer.state_dict()
    live = _live(optimizer)
    out = {}
    for i, st in sd["state"].items():
        p = live[i]
        name = names[id(p)]
        spec = list(param_specs[name])
        out[name] = {}
        for k, t in st.items():
            if torch.is_tensor(t):
                gone = None if t.dim() == 0 else _gone_dim(full_shape(p), k, t.dim(),
                                                           _group_of(sd, i))
                kept = spec if gone is None else spec[:gone] + spec[gone + 1:]
                out[name][k] = P(*kept) if t.dim() else P()
    return out


# --- the whole state ---------------------------------------------------------------------


def _buckets(idx: list, ts: list) -> list:
    out, cur, size = [], [], 0
    for i in idx:
        n = ts[i].numel() * ts[i].element_size()
        if cur and size + n > GRAD_BUCKET_BYTES:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
    return out + ([cur] if cur else [])


def _gather_whole(items: list, keep: bool) -> list:
    """Each (tensor, cuts) whole, on the host where ``keep`` (else None):
    gathered over its cuts, the last made first, in flat buckets of at most
    ``GRAD_BUCKET_BYTES`` (one all-gather a bucket), each tensor moved to
    the host once it is whole."""
    cur = [t.detach() for t, _ in items]
    todo = [list(c) for _, c in items]
    done = lambda i: cur[i].cpu() if keep else None
    for i, c in enumerate(todo):
        if not c:
            cur[i] = done(i)
    while any(todo):
        groups = {}
        for i, c in enumerate(todo):
            if c:
                ax = c[-1][1]
                groups.setdefault((ax.name, cur[i].dtype), (ax, []))[1].append(i)
        for ax, idx in groups.values():
            for bucket in _buckets(idx, cur):
                wholes = _gather_flat([cur[i] for i in bucket],
                                      [todo[i][-1][0] for i in bucket], ax)
                for i, w in zip(bucket, wholes):
                    cur[i] = w
                    todo[i].pop()
                    if not todo[i]:
                        cur[i] = done(i)
    return cur


def _entries(state, sd: dict) -> list:
    """(container, key, tensor, cuts) of every tensor of a state dict in the
    ``TrainState.state_dict()`` format, the containers copied so they may
    be filled."""
    params = dict(state.model.named_parameters())
    live = _live(state.optimizer)
    out = []
    sd["params"] = dict(sd["params"])
    for n, t in sd["params"].items():
        out.append((sd["params"], n, t, cuts(params[n]) if n in params else ()))
    if sd.get("ema") is not None:
        sd["ema"] = dict(sd["ema"])
        out += [(sd["ema"], n, t, cuts(params[n])) for n, t in sd["ema"].items()]
    opt = sd["optimizer"] = dict(sd["optimizer"])
    opt["state"] = {i: dict(st) for i, st in opt["state"].items()}
    for i, st in opt["state"].items():
        group = _group_of(opt, i)
        out += [(st, k, t, _state_cuts(live[i], k, t.dim(), group))
                for k, t in st.items() if torch.is_tensor(t)]
    if "masters" in opt:
        opt["masters"] = list(opt["masters"])
        out += [(opt["masters"], i, m, cuts(live[i])) for i, m in enumerate(opt["masters"])]
    return out


def gather_state(state, dst: Optional[int] = None) -> Optional[dict]:
    """The whole train state in the unsharded ``TrainState.state_dict()``
    format, its tensors on the host: on every rank, or (``dst`` a global
    rank) on that rank alone, None elsewhere.  Collective: every rank of the
    mesh calls it."""
    sd = state.local_state_dict()
    entries = _entries(state, sd)
    keep = dst is None or dist.get_rank() == dst
    wholes = _gather_whole([(t, c) for _, _, t, c in entries], keep)
    if not keep:
        return None
    for (box, key, _, _), w in zip(entries, wholes):
        box[key] = w
    return sd


def place_state(state, saved: dict) -> None:
    """Load a whole state (the unsharded ``TrainState.state_dict()`` format,
    as ``gather_state`` or an unsharded run saves it) into a sharded
    ``state``: each rank keeps its slices.  Raises ValueError where a
    tensor's whole shape is not the saved one's."""
    params = dict(state.model.named_parameters())
    lengths = lambda sd: [len(g["params"]) for g in sd["param_groups"]]
    if lengths(saved["optimizer"]) != lengths(state.optimizer.state_dict()):
        raise ValueError("the saved optimizer's parameters are not this state's: the "
                         "structure changed since it was saved")
    for name, t in saved["params"].items():
        if name in params and tuple(t.shape) != full_shape(params[name]):
            raise ValueError(f"the saved {name} has shape {tuple(t.shape)}, the model's "
                             f"{full_shape(params[name])}: the structure changed")
    local = dict(saved)
    for box, key, t, made in _entries(state, local):
        box[key] = _slice(t, made)
    state.load_local_state_dict(local)


def state_bytes(state) -> dict:
    """Bytes this rank holds of the parameters, the EMA and the optimizer
    state."""
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))
    opt = state.optimizer
    inner = getattr(opt, "inner", opt)
    out = {"params": size(state.model.parameters()),
           "ema": size((state.ema_params or {}).values()),
           "optimizer": size(t for st in inner.state.values() for t in st.values())}
    if inner is not opt:
        out["optimizer"] += size(opt.masters)
    return out
