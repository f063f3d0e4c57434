"""The rank side of ``test_torch_spatial_parallel22.py``: functions that
every rank of a ``parallel.launch.RankPool`` runs as ``fn(mesh, ...)``, in
fp32 on the CPU.  Each builds the port's UNet22 or pipeline from the numpy
arrays it is handed (JAX's parameters as numpy trees) or from a torch seed,
runs it row-sharded and unsharded, and returns numpy arrays from rank 0 of
its (sub-)mesh.  This module imports no JAX."""

import contextlib

import numpy as np
import torch

from kandinsky2_tpu_torch.parallel import spatial as sp
from kandinsky2_tpu_torch.parallel.collectives import all_gather
from kandinsky2_tpu_torch.parallel.mesh import Mesh
from kandinsky2_tpu_torch.weights.from_jax import load_jax_params, lora_from_jax
from torch_sp_ranks import _first, _np, _t, sub_mesh

_PIPES = {}


@contextlib.contextmanager
def flash_route(on: bool):
    """Every unmasked fp32 attention down K3's route (the kernel's plain
    version, and K5/K4's in the backward, on the CPU) while the block
    runs, as ``test_torch_common.flash_route`` does in the test process."""
    from kandinsky2_tpu_torch.ops import attention as tattn

    saved = tattn.use_flash_kernel
    if on:
        tattn.use_flash_kernel = lambda q, k, v: True
    try:
        yield
    finally:
        tattn.use_flash_kernel = saved


# --- the UNet22 -------------------------------------------------------------------


def _unet22(kw, params):
    from kandinsky2_tpu_torch.models.unet22 import UNet22

    return load_jax_params(UNet22(**kw), params)


def unet22(mesh, n, kw, params, x, t, emb, hint=None):
    """(sharded, unsharded) forward of a port ``UNet22`` built from ``kw``:
    x's rows sharded over the first ``n`` ranks, the hint whole."""
    m = sub_mesh(mesh, n)
    if m is None:
        return None
    ax = m.axis()
    model = _unet22(kw, params)
    h = None if hint is None else _t(hint)
    with torch.no_grad():
        whole = model(_t(x), _t(t), _t(emb), h)
        with sp.using_sp_axis(model, ax):
            got = all_gather(model(sp.shard_rows(_t(x), ax), _t(t), _t(emb), h), ax, dim=1)
    return _first(m, (_np(got), _np(whole)))


def unet22_cached(mesh, n, kw, params, x, t, emb):
    """``denoise_cached`` twice, refreshing, then from the cache the first
    call left (this rank's rows of it where sharded): (sharded, unsharded)
    outputs of both calls and the cache."""
    m = sub_mesh(mesh, n)
    if m is None:
        return None
    ax = m.axis()
    model = _unet22(kw, params)

    def calls(xx):
        es, aug, hl = model.encode_conditioning(_t(emb))
        out1, cache = model.denoise_cached(xx, _t(t), es, aug, hl, None, True)
        out2, _ = model.denoise_cached(xx, _t(t) * 0.5, es, aug, hl, cache, False)
        return out1, out2, cache

    with torch.no_grad():
        whole = calls(_t(x))
        with sp.using_sp_axis(model, ax):
            got = [all_gather(o, ax, dim=1) for o in calls(sp.shard_rows(_t(x), ax))]
    return _first(m, ([_np(o) for o in got], [_np(o) for o in whole]))


# --- the 2.2 and 2.0 pipelines --------------------------------------------------


def _pipe(version, task, cfg, params=None, seed=0):
    """The port's pipeline on this rank, built once per (version, task,
    configuration, parameters): JAX's numpy parameters where given, else
    the port's own seeded draw."""
    key = (version, task, repr(cfg), "jax" if params is not None else seed)
    if key in _PIPES:
        return _PIPES[key]
    if version == "2.2":
        from kandinsky2_tpu_torch.pipelines import Kandinsky2_2
        from kandinsky2_tpu_torch.utils import stub_tokenizer22

        pipe = Kandinsky2_2(task_type=task, dtype=torch.float32, overrides=cfg,
                            tokenizer=stub_tokenizer22(cfg["text_encoder"]["vocab_size"]),
                            device="cpu")
    else:
        from kandinsky2_tpu_torch.pipelines import Kandinsky2
        from kandinsky2_tpu_torch.utils import stub_tokenizers

        tok, _ = stub_tokenizers(64)
        pipe = Kandinsky2(config=cfg, tokenizer1=tok, tokenizer2=tok, task_type=task,
                          dtype=torch.float32, device="cpu")
    if params is None:
        pipe.init_random_params(torch.Generator().manual_seed(seed))
    else:
        pipe.load_jax_params(params)
    _PIPES[key] = pipe
    return pipe


def _inject_decoder22(pipe, seed):
    """``test_torch_common.inject_decoder22`` on this rank: the x_T and the
    ddpm per-step noise that ``_decode_loop`` would draw, from a numpy seed
    wherever the caller passes none (the whole latent's, the same on every
    rank)."""
    rng = np.random.RandomState(seed)
    inner = type(pipe)._decode_loop.__get__(pipe)

    def _decode_loop(image_embeds, batch_size, steps, guidance, h, w, x_T=None,
                     ladder=None, sampler="ddpm", noise_seq=None, **kw):
        if x_T is None:
            x_T = torch.from_numpy(rng.randn(batch_size, h // 8, w // 8, 4)
                                   .astype(np.float32))
        n = steps if ladder is None else len(ladder)
        if noise_seq is None and sampler == "ddpm":
            noise_seq = rng.randn(n, *x_T.shape).astype(np.float32)
        return inner(image_embeds, batch_size, steps, guidance, h, w, x_T=x_T,
                     ladder=ladder, sampler=sampler, noise_seq=noise_seq, **kw)

    pipe._decode_loop = _decode_loop


def pipeline(mesh, n, version, task, cfg, entry, kw, seed=0, inject=None,
             params=None):
    """``entry`` of the port's ``version`` pipeline with ``sp_mesh`` over
    the first ``n`` ranks (float images, from rank 0), after
    ``set_seed(seed)`` on every rank; the same call unsharded where ``n``
    is 0.  ``inject``: the seed of the 2.2 decoder's injected draws.  A
    ``ValueError``'s message is returned in place of the images."""
    pipe = _pipe(version, task, cfg, params)
    m = mesh if n == 0 else sub_mesh(mesh, n)
    if m is None:
        return None
    kw = dict(kw, output="float")
    if n:
        kw["sp_mesh"] = m
    pipe.set_seed(seed)
    if inject is not None:
        _inject_decoder22(pipe, inject)
    try:
        out = getattr(pipe, entry)(**kw)
    except ValueError as e:
        return _first(m, str(e))
    finally:
        pipe.__dict__.pop("_decode_loop", None)
    return _first(m, np.asarray(out))


def decode_loop22(mesh, n, cfg, params, image_embeds, x_T, noise_seq, steps, guidance,
                  h, w):
    """The 2.2 pipeline's ``_decode_loop`` (ddpm) on JAX's parameters with
    the given draws, row-sharded over the first ``n`` ranks: the float
    images from rank 0."""
    pipe = _pipe("2.2", "text2img", cfg, params)
    m = sub_mesh(mesh, n)
    if m is None:
        return None
    with torch.no_grad():
        out = pipe._decode_loop(_t(image_embeds), x_T.shape[0], steps, guidance, h, w,
                                x_T=_t(x_T), noise_seq=_t(noise_seq), sp_mesh=m)
    return _first(m, _np(out))


# --- sharded LoRA ------------------------------------------------------------------


def _sgd(lr):
    from kandinsky2_tpu_torch.train.optim import optimizer_from_config

    return optimizer_from_config({"name": "optax.sgd", "params": {"learning_rate": lr}})


def _factors(state):
    return {k: _np(v) for k, v in state.params.items()}


def sp_lora_steps(mesh, shape, kw, params, loras, acp, x0, cond, ts, noises, lr,
                  sharded=False):
    """``make_sp_lora_train_fn`` on a ``shape`` (data, sp) mesh of the
    pool's ranks, the UNet22's added-KV attention down K3's route (K5 and
    K4's plain versions in the backward): one ``optax.sgd(lr)`` step a
    (t, noise) pair, each the whole batch's (with ``sharded``, this rank
    cuts its own shard and hands only that).  Every rank's losses and
    factors, and whether the base stayed bitwise as it was."""
    from kandinsky2_tpu_torch.train.train_lora import make_sp_lora_train_fn, unet22_eps_fn

    grid = Mesh(None, ("data", "sp"), shape=shape)
    data, rows = grid.axis("data"), grid.axis("sp")
    unet = _unet22(kw, params)
    base = {n: p.detach().clone() for n, p in unet.named_parameters()}
    init_state, train_fn = make_sp_lora_train_fn(
        unet22_eps_fn(unet, rows), unet, acp, _sgd(lr), grid)
    state = init_state(lora_from_jax(loras))

    def cut(a, is_rows):
        a = _t(a).chunk(data.size)[data.index]
        return sp.shard_rows(a, rows) if is_rows else a

    x0, cond = _t(x0), _t(cond)
    if sharded:
        x0, cond = cut(x0, True), cut(cond, False)
    losses = []
    with flash_route(True):
        for t, noise in zip(ts, noises):
            t, noise = (cut(t, False), cut(noise, True)) if sharded else (_t(t), _t(noise))
            losses.append(float(train_fn(state, x0, cond, t, noise, sharded=sharded)["loss"]))
    same_base = all(torch.equal(p.detach(), base[n]) and p.grad is None
                    for n, p in unet.named_parameters())
    return dict(losses=losses, factors=_factors(state), same_base=same_base,
                step=state.step)

