"""The rank side of ``test_torch_fsdp.py``: functions that every rank of a
``parallel.launch.RankPool`` runs as ``fn(mesh, ...)``, in fp32 on the CPU.
Each builds what it needs from the numpy arrays it is handed (JAX's
parameters as numpy trees), runs the port's sharded train step, optimizer
or loop, and returns numpy arrays.  This module imports no JAX."""

import os

import numpy as np
import torch

from kandinsky2_tpu_torch.parallel import fsdp
from kandinsky2_tpu_torch.parallel.mesh import fsdp_state_shardings, make_mesh
from kandinsky2_tpu_torch.weights.from_jax import load_jax_params
from torch_sp_ranks import _np, _t


def _tiny_unet(mc, params):
    from kandinsky2_tpu_torch.configs import create_model

    return load_jax_params(create_model(**mc, dtype=torch.float32), params)


def _optimizer(optim):
    from kandinsky2_tpu_torch.train.optim import optimizer_from_config

    return optimizer_from_config(optim)


def _full(state):
    """The whole state gathered (collective) as numpy: parameters, EMA."""
    sd = state.state_dict()
    return ({n: _np(v) for n, v in sd["params"].items()},
            None if sd["ema"] is None else {n: _np(v) for n, v in sd["ema"].items()})


def fsdp_steps(mesh, shape, mc, dcfg, params, batch, ts, noises, optim, *, tp=False,
               tp_min_size=1024, accum_steps=1, min_elems=1 << 10,
               sampler="loss-second-moment", ema_decay=0.999, freeze_resblocks=True):
    """``make_fsdp_train_fn`` on a ``shape`` (data, model) mesh of the
    pool's first ranks (None on the others): one step a (t, noise) pair of
    the whole batch.  Returns each step's metrics, the gathered parameters
    and EMA, the sampler's history and counts, and what a rank holds: each
    parameter's local and whole element counts and the bytes of its state."""
    from kandinsky2_tpu_torch.train.optim import decoder_freeze_mask
    from kandinsky2_tpu_torch.train.train_unclip import make_fsdp_train_fn

    d, m = shape
    grid = make_mesh(d * m, model_parallel=m)
    if grid is None:
        return None
    unet = _tiny_unet(mc, params)
    mask = decoder_freeze_mask(unet, freeze_resblocks=freeze_resblocks)
    init_fn, train_fn, _ = make_fsdp_train_fn(
        unet, dcfg, _optimizer(optim), grid, tp=tp, min_elems=min_elems,
        tp_min_size=tp_min_size, schedule_sampler=sampler, ema_decay=ema_decay,
        accum_steps=accum_steps)
    state = init_fn(mask, seed=0)
    batch = {k: _t(v) for k, v in batch.items()}
    fsdp.reset_collective_counts()
    metrics = [{k: float(v) for k, v in train_fn(state, batch, _t(t), _t(n)).items()}
               for t, n in zip(ts, noises)]
    counts = fsdp.collective_counts()
    held = {n: (p.numel(), int(np.prod(fsdp.full_shape(p))))
            for n, p in unet.named_parameters()}
    opt_held = {n: {k: v.numel() for k, v in state.optimizer.state[p].items()
                    if torch.is_tensor(v) and v.dim()}
                for n, p in unet.named_parameters() if p in state.optimizer.state}
    ema_held = {n: e.numel() for n, e in state.ema_params.items()} \
        if state.ema_params is not None else None
    # the placement read back from the sharded state: each cut where the
    # placement put it, each moment its parameter's spec
    specs = fsdp_state_shardings(state, grid, tp=tp, min_elems=min_elems,
                                 tp_min_size=tp_min_size)
    placed = all(
        [d for d, ax in enumerate(specs["params"][n]) if ax == "data"]
        == ([p.fsdp_shard[0]] if hasattr(p, "fsdp_shard") else [])
        for n, p in unet.named_parameters())
    moments = {n: v == {"mu": specs["params"][n], "nu": specs["params"][n]}
               for n, v in specs["optimizer"].items()}
    whole, ema = _full(state)
    return dict(metrics=metrics, params=whole, ema=ema, step=state.step,
                placed=placed, moments=moments,
                history=None if state.sampler is None else _np(state.sampler.history),
                counts=None if state.sampler is None else state.sampler.counts.numpy(),
                held=held, opt_held=opt_held, ema_held=ema_held, collectives=counts)


def adafactor_shards(mesh, cases, grads, kw):
    """``Adafactor(**kw)`` over slices of whole tensors cut on ``cases``'
    dims over the pool's ranks: {name: (whole tensor, cut dim)}; ``grads``
    a list of steps, each {name: whole gradient}.  Returns every tensor
    whole after the steps and its optimizer state gathered (rank 0)."""
    from kandinsky2_tpu_torch.train.optim import Adafactor

    grid = make_mesh(mesh.axis().size, model_parallel=1)
    ax = grid.axis("data")
    params = {}
    for name, (whole, dim) in cases.items():
        p = torch.nn.Parameter(_t(whole).clone())
        if dim is not None:
            fsdp.cut_(p, dim, ax)
        params[name] = p
    opt = Adafactor(list(params.values()), **kw)
    for step in grads:
        for name, p in params.items():
            p.grad = fsdp._slice(_t(step[name]), fsdp.cuts(p))
        opt.step()
    out = {}
    for name, p in params.items():
        st = opt.state[p]
        items = [(p.detach(), fsdp.cuts(p))] + [
            (v, fsdp._state_cuts(p, k, v.dim(), opt.param_groups[0]))
            for k, v in st.items() if torch.is_tensor(v)]
        wholes = fsdp._gather_whole(items, True)
        keys = ["param"] + [k for k, v in st.items() if torch.is_tensor(v)]
        out[name] = {k: _np(w) for k, w in zip(keys, wholes)}
    return out if ax.index == 0 else None


def train_loop(mesh, mc, dcfg, params, batches, save_path, optim, fsdp_n):
    """``train_unclip(fsdp=fsdp_n)`` (None: unsharded, on rank 0 alone)
    over ``batches`` with a save every step; then the step, the whole
    parameters (gathered) and the checkpoint files on rank 0."""
    from kandinsky2_tpu_torch.train.train_unclip import train_unclip

    if fsdp_n is None:
        if mesh.axis().index:
            return None
        mesh = None
    unet = _tiny_unet(mc, params)
    state = train_unclip(
        unet=unet, diffusion_config=dcfg, loader=batches,
        prepare_batch=lambda raw: {k: _t(v) for k, v in raw.items()},
        optimizer_factory=_optimizer(optim), save_every=1, save_path=save_path,
        ema_decay=0.999, log_every=100, freeze_resblocks=True, fsdp=fsdp_n,
        schedule_sampler="loss-second-moment")
    if state is None:
        return None
    sd = state.state_dict()
    if fsdp_n is not None and torch.distributed.get_rank():
        return None
    return dict(step=state.step, files=sorted(os.listdir(save_path)),
                params={n: _np(v) for n, v in sd["params"].items()},
                ema={n: _np(v) for n, v in sd["ema"].items()},
                opt={i: {k: _np(v) for k, v in st.items() if torch.is_tensor(v)}
                     for i, st in sd["optimizer"]["state"].items()})
