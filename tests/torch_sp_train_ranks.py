"""The rank side of ``test_torch_sp_train.py``: functions that every rank of
a ``parallel.launch.RankPool`` runs as ``fn(mesh, ...)``, in fp32 on the
CPU.  Each builds what it needs from the numpy arrays it is handed (JAX's
parameters as numpy trees), runs the port's sharded backward or train
step, and returns numpy arrays.  This module imports no JAX."""

import numpy as np
import torch

from kandinsky2_tpu_torch.parallel import spatial as sp
from kandinsky2_tpu_torch.parallel.collectives import (
    all_gather,
    pmean,
    pmean_grads,
    ppermute,
    psum,
)
from kandinsky2_tpu_torch.parallel.mesh import Mesh
from kandinsky2_tpu_torch.weights.from_jax import load_jax_params
from torch_sp_ranks import _np, _t, sub_mesh


def _gather_all(t, ax):
    """Every rank's ``t`` stacked in axis order: [n, ...]."""
    return _np(all_gather(t.detach().contiguous()[None], ax, dim=0))


def collective_grads(mesh, kind, xs, gs):
    """The gradient of ``sum(collective(x_r) * g_r)`` on each rank r, where
    ``xs`` and ``gs`` hold every rank's x and g: [n][...]."""
    ax = mesh.axis()
    x = _t(xs[ax.index]).clone().requires_grad_()
    if kind == "ppermute":
        y = ppermute(x, ax, [(i, (i + 1) % ax.size) for i in range(ax.size)])
    elif kind == "psum":
        y = psum(x, ax)
    elif kind == "pmean":
        y = pmean(x, ax)
    elif kind == "all_gather":
        y = all_gather(x, ax, dim=1)
    elif kind == "halo_exchange_rows":
        y = sp.halo_exchange_rows(x, ax)
    elif kind == "halo_below_rows":
        y = sp.halo_below_rows(x, ax)
    else:
        raise ValueError(kind)
    (y * _t(gs[ax.index])).sum().backward()
    grads = _gather_all(x.grad, ax)
    return grads if ax.index == 0 else None


def group_norm_grads(mesh, n, x, gy, scale, bias, groups, swish, film):
    """(sharded, unsharded) gradients of ``GroupNorm32`` with respect to x,
    its scale and bias and the FiLM pair (where given): the x gradients
    gathered over the rows, the rest summed over the ranks."""
    from kandinsky2_tpu_torch.models.layers import GroupNorm32

    m = sub_mesh(mesh, n)
    if m is None:
        return None
    ax = m.axis()
    norm = GroupNorm32(x.shape[-1], groups, 1e-5, swish)
    with torch.no_grad():
        norm.weight.copy_(_t(scale))
        norm.bias.copy_(_t(bias))

    def grads(sharded):
        norm.zero_grad()
        xx = _t(x).clone().requires_grad_()
        f = None if film is None else tuple(_t(a).clone().requires_grad_() for a in film)
        if sharded:
            with sp.using_sp_axis(norm, ax):
                y = norm(sp.shard_rows(xx, ax), film=f)
            g = sp.shard_rows(_t(gy), ax)
        else:
            y, g = norm(xx, film=f), _t(gy)
        y.backward(g)
        out = [xx.grad, norm.weight.grad, norm.bias.grad] + ([] if f is None else
                                                            [a.grad for a in f])
        if sharded:  # each rank's x gradient is zero outside its rows
            out = [psum(o, ax) for o in out]
        return [_np(o) for o in out]

    return grads(True), grads(False) if ax.index == 0 else None


def attention_grads(mesh, impl, q, k, v, ek, ev, go, q_chunk=4):
    """Gradients of the UNet's sharded attention (q, k, v [B, T, H, c]
    whole, the text prefix ek, ev [B, E, H, c]) with output gradient
    ``go``: ``impl`` "gathered" (``qkv_attention`` on the all-gathered
    spatial K/V after the prefix), "ring" (the plain fold, queries in
    chunks of ``q_chunk``) or "ring flash" (``RingFlashFunction``: the
    plain versions of K3, K5 and K4 on the CPU).  Returns (q, k, v, ek, ev)
    gradients, the row ones gathered, the prefix ones summed; and the
    unsharded ``qkv_attention``'s, on rank 0 (None on the others)."""
    from kandinsky2_tpu_torch.ops.attention import qkv_attention

    ax = mesh.axis()
    leaves = [_t(a).clone().requires_grad_() for a in (q, k, v, ek, ev)]
    qq, kk, vv, eek, eev = leaves
    rows = lambda t: sp.shard_rows(t, ax)
    if impl == "gathered":
        kf = torch.cat([eek, all_gather(rows(kk), ax, dim=1)], dim=1)
        vf = torch.cat([eev, all_gather(rows(vv), ax, dim=1)], dim=1)
        o = qkv_attention(rows(qq), kf, vf)
    elif impl == "ring":
        o = sp.sp_ring_attention_mh(rows(qq), rows(kk), rows(vv), ax, extra_k=eek,
                                    extra_v=eev, q_chunk=q_chunk)
    elif impl == "ring flash":
        o = sp._ring_flash(rows(qq), rows(kk), rows(vv), ax, eek, eev)
    else:
        raise ValueError(impl)
    o.backward(rows(_t(go)))
    got = [psum(t.grad, ax) for t in leaves]
    if ax.index:
        return None
    for t in leaves:
        t.grad = None
    whole = qkv_attention(qq, torch.cat([eek, kk], 1), torch.cat([eev, vv], 1))
    whole.backward(_t(go))
    return [_np(g) for g in got], [_np(t.grad) for t in leaves]


def unet_grads(mesh, kw, params, x, t, enc, tgt, ring):
    """The row-sharded UNet's loss and parameter gradients (the JAX test's
    loss: the psum'd squared error over the global count, gradients
    pmean'd over the axis), and the unsharded UNet's, by parameter name, on
    rank 0 (None on the others)."""
    from kandinsky2_tpu_torch.models.unet import UNetModel

    ax = mesh.axis()
    unet = load_jax_params(UNetModel(**kw), params)
    x, t, enc, tgt = (_t(a) for a in (x, t, enc, tgt))
    names = [n for n, _ in unet.named_parameters()]
    saved = sp.RING_THRESHOLD_TOKENS
    if ring:
        sp.RING_THRESHOLD_TOKENS = 1
    try:
        with sp.using_sp_axis(unet, ax):
            out = unet(sp.shard_rows(x, ax), t, enc)
            sse = psum(((out - sp.shard_rows(tgt, ax)) ** 2).sum(), ax)
            loss = sse / tgt.numel()
            loss.backward()
    finally:
        sp.RING_THRESHOLD_TOKENS = saved
    pmean_grads(list(unet.parameters()), ax)
    got = {n: _np(p.grad) for n, p in unet.named_parameters()}
    if ax.index:
        return None
    unet.zero_grad(set_to_none=True)
    whole = ((unet(x, t, enc) - tgt) ** 2).mean()
    whole.backward()
    ref = {n: _np(p.grad) for n, p in unet.named_parameters()}
    return dict(loss=float(loss.detach()), whole_loss=float(whole.detach()), grads=got,
                ref=ref, names=names)


def _sd(model):
    return {n: _np(p) for n, p in model.state_dict().items()}


def _tiny_unet(mc, params):
    from kandinsky2_tpu_torch.configs import create_model

    return load_jax_params(create_model(**mc, dtype=torch.float32), params)


def _sgd(lr):
    from kandinsky2_tpu_torch.train.optim import optimizer_from_config

    return optimizer_from_config({"name": "optax.sgd", "params": {"learning_rate": lr}})


def spdp_steps(mesh, shape, mc, dcfg, params, batch, ts, noises, lr, accum_steps=1,
               sampler="loss-second-moment", ema_decay=0.999, sharded=False):
    """``make_spdp_train_fn`` on a ``shape`` (data, sp) mesh of the pool's
    ranks: one step a (t, noise) pair, each the whole batch's (with
    ``sharded``, this rank cuts its own shard of each and hands only that),
    with the optimizer ``optax.sgd(lr)``.  Returns each step's metrics, the
    parameters, the EMA, the sampler's history and counts after the last
    step, from every rank."""
    from kandinsky2_tpu_torch.train.train_unclip import make_spdp_train_fn

    m = Mesh(None, ("data", "sp"), shape=shape)
    unet = _tiny_unet(mc, params)
    init_state, train_fn = make_spdp_train_fn(
        unet, dcfg, _sgd(lr), m, schedule_sampler=sampler, ema_decay=ema_decay,
        accum_steps=accum_steps)
    state = init_state(seed=0)
    data, rows = m.axis("data"), m.axis("sp")

    def cut(a, is_rows):
        a = _t(a).chunk(data.size)[data.index]
        return sp.shard_rows(a, rows) if is_rows else a

    if sharded:
        batch = {k: cut(v, v.ndim == 4) for k, v in batch.items()}
        ts, noises = [cut(t, False) for t in ts], [cut(n, True) for n in noises]
    else:
        batch = {k: _t(v) for k, v in batch.items()}
        ts, noises = [_t(t) for t in ts], [_t(n) for n in noises]
    metrics = []
    for t, noise in zip(ts, noises):
        out = train_fn(state, batch, t=t, noise=noise, sharded=sharded)
        metrics.append({k: float(v) for k, v in out.items()})
    return dict(
        metrics=metrics, params=_sd(unet), step=state.step,
        ema=None if state.ema_params is None else {n: _np(e) for n, e in
                                                   state.ema_params.items()},
        history=None if state.sampler is None else _np(state.sampler.history),
        counts=None if state.sampler is None else state.sampler.counts.numpy())


def single_steps(mesh, mc, dcfg, params, batch, ts, noises, lr, ema_decay=None):
    """The unsharded ``make_unclip_train_step`` on the whole batch with the
    same draws and optimizer, on rank 0 (None on the others)."""
    from kandinsky2_tpu_torch.train.train_unclip import make_unclip_train_step

    if mesh.axis().index:
        return None
    unet = _tiny_unet(mc, params)
    init_state, step = make_unclip_train_step(unet, dcfg, _sgd(lr), ema_decay=ema_decay)
    state = init_state(seed=0)
    batch = {k: _t(v) for k, v in batch.items()}
    metrics = [{k: float(v) for k, v in step(state, batch, _t(t), _t(n)).items()}
               for t, n in zip(ts, noises)]
    return dict(metrics=metrics, params=_sd(unet))


def prior_steps(mesh, n, hp, dcfg, params, batch, ts, noises, lr):
    """``make_prior_train_step(data_axis=)`` on the pool's first ``n`` ranks,
    each taking its examples of the whole batch; the loss of every step and
    the parameters from every rank of the sub-mesh."""
    from kandinsky2_tpu_torch.models.prior import PriorTransformer
    from kandinsky2_tpu_torch.train.train_prior import make_prior_train_step

    m = sub_mesh(mesh, n)
    if m is None:
        return None
    ax = m.axis()
    prior = load_jax_params(PriorTransformer(**hp), params)
    init_state, step = make_prior_train_step(prior, dcfg, _sgd(lr), ema_decay=0.9999,
                                             data_axis=ax)
    state = init_state()
    shard = lambda a: torch.from_numpy(np.asarray(a)).chunk(ax.size)[ax.index]
    losses = [float(step(state, {k: shard(v) for k, v in batch.items()}, t=shard(t),
                         noise=shard(noise))["loss"]) for t, noise in zip(ts, noises)]
    return dict(losses=losses, params=_sd(prior))


def train_loop(mesh, mc, dcfg, params, batches, save_path, shape, lr):
    """``train_unclip(mesh_shape=shape)`` over ``batches`` (a list of whole
    batches, the same on every rank) with a save every step; then every
    rank's step, its parameters and which checkpoint files exist."""
    import os

    from kandinsky2_tpu_torch.train.train_unclip import train_unclip

    unet = _tiny_unet(mc, params)
    state = train_unclip(
        unet=unet, diffusion_config=dcfg, loader=batches,
        prepare_batch=lambda raw: {k: _t(v) for k, v in raw.items()},
        optimizer_factory=_sgd(lr), save_every=1, save_path=save_path, ema_decay=None,
        log_every=1, mesh_shape=shape)
    return dict(step=state.step, params=_sd(unet), files=sorted(os.listdir(save_path)))
