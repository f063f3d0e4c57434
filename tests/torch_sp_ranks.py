"""The rank side of ``test_torch_spatial_parallel*.py``: functions that
every rank of a ``parallel.launch.RankPool`` runs as ``fn(mesh, ...)``.

Each case runs on the first ``n`` ranks of the pool (a sub-mesh of the
pool's four), builds the port's module on the CPU in fp32 from the JAX
parameters it is handed (numpy trees), runs it row-sharded and unsharded,
and returns numpy arrays from rank 0 (None elsewhere).  This module
imports no JAX: the ranks are PyTorch processes."""

import numpy as np
import torch
import torch.distributed as dist

from kandinsky2_tpu_torch.parallel import spatial as sp
from kandinsky2_tpu_torch.parallel.collectives import all_gather
from kandinsky2_tpu_torch.parallel.mesh import Mesh
from kandinsky2_tpu_torch.weights.from_jax import load_jax_params

_SUB = {}
_PIPES = {}


def sub_mesh(mesh, n):
    """The mesh of the pool's first ``n`` ranks (None on the others); every
    rank of the pool calls it, since making a group is collective."""
    if n == mesh.axis().size:
        return mesh
    if n not in _SUB:
        _SUB[n] = dist.new_group(list(range(n)))
    return Mesh(_SUB[n]) if mesh.axis().index < n else None


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().float().numpy()


def _first(mesh, value):
    """``value`` from rank 0 of the sub-mesh, None elsewhere."""
    return value if mesh.axis().index == 0 else None


def halo(mesh, n, x, below=False):
    """Every rank's halo block of x's rows: [n][B, Hl + 2 (or + 1), W, C]."""
    m = sub_mesh(mesh, n)
    if m is None:
        return None
    ax = m.axis()
    f = sp.halo_below_rows if below else sp.halo_exchange_rows
    blocks = all_gather(f(sp.shard_rows(_t(x), ax), ax)[None], ax, dim=0)
    return _first(m, _np(blocks))


def group_norm(mesh, n, x, scale, bias, groups, eps, swish, film):
    """(sharded, unsharded) GroupNorm of x through ``GroupNorm32``."""
    from kandinsky2_tpu_torch.models.layers import GroupNorm32

    m = sub_mesh(mesh, n)
    if m is None:
        return None
    ax = m.axis()
    norm = GroupNorm32(x.shape[-1], groups, eps, swish)
    with torch.no_grad():
        norm.weight.copy_(_t(scale))
        norm.bias.copy_(_t(bias))
        f = None if film is None else tuple(_t(a) for a in film)
        whole = norm(_t(x), film=f)
        with sp.using_sp_axis(norm, ax):
            got = all_gather(norm(sp.shard_rows(_t(x), ax), film=f), ax, dim=1)
    return _first(m, (_np(got), _np(whole)))


def attention_rows(mesh, n, q, k, v, impl, q_chunk=None):
    """``sp_attention_rows`` (or the ring with ``q_chunk``) on row shards."""
    m = sub_mesh(mesh, n)
    if m is None:
        return None
    ax = m.axis()
    qkv = [sp.shard_rows(_t(a), ax) for a in (q, k, v)]
    if q_chunk is None:
        out = sp.sp_attention_rows(*qkv, ax, impl=impl)
    else:
        out = sp.sp_ring_attention_rows(*qkv, ax, q_chunk=q_chunk)
    return _first(m, (_np(all_gather(out, ax, dim=1)), str(out.dtype)))


def ring_mh(mesh, n, q, k, v, ek, ev, q_chunk):
    """``sp_ring_attention_mh`` with a replicated prefix; q/k/v
    [B, T, H, c] sharded along T."""
    m = sub_mesh(mesh, n)
    if m is None:
        return None
    ax = m.axis()
    out = sp.sp_ring_attention_mh(*(sp.shard_rows(_t(a), ax) for a in (q, k, v)), ax,
                                  extra_k=_t(ek), extra_v=_t(ev), q_chunk=q_chunk)
    return _first(m, _np(all_gather(out, ax, dim=1)))


def threshold(mesh, n, x):
    """``dynamic_threshold`` over the axis on row shards, and unsharded."""
    from kandinsky2_tpu_torch.diffusion.gaussian import dynamic_threshold

    m = sub_mesh(mesh, n)
    if m is None:
        return None
    ax = m.axis()
    got = all_gather(dynamic_threshold(sp.shard_rows(_t(x), ax), axis=ax), ax, dim=1)
    return _first(m, (_np(got), _np(dynamic_threshold(_t(x)))))


def _codec(kind, kw, params):
    from kandinsky2_tpu_torch.models import movq

    cls = {"movq": movq.MOVQ, "kl": movq.AutoencoderKL}[kind]
    return load_jax_params(cls(**kw), params)


def codec(mesh, n, kind, kw, params, x, method):
    """(sharded, unsharded) outputs of the codec's ``method`` on x: decode
    through ``spatial_decode``, encode through ``spatial_encode`` (the KL
    codec's mean and log-variance stacked)."""
    m = sub_mesh(mesh, n)
    if m is None:
        return None
    model = _codec(kind, kw, params)
    x = _t(x)
    with torch.no_grad():
        if method == "encode":
            got, whole = sp.spatial_encode(model, x, m), model.encode(x)
        else:
            got, whole = sp.spatial_decode(model, x, m, method=method), \
                getattr(model, method)(x)
    if isinstance(got, tuple):
        got, whole = torch.stack(got), torch.stack(whole)
    return _first(m, (_np(got), _np(whole)))


def unet(mesh, n, kw, params, x, t, enc, ring=False):
    """(sharded, unsharded) forward of a port ``UNetModel`` built from
    ``kw``; ``ring`` routes its sharded attention through the ring."""
    from kandinsky2_tpu_torch.models.unet import UNetModel

    m = sub_mesh(mesh, n)
    if m is None:
        return None
    ax = m.axis()
    model = load_jax_params(UNetModel(**kw), params)
    saved = sp.RING_THRESHOLD_TOKENS
    sp.RING_THRESHOLD_TOKENS = 1 if ring else saved
    try:
        with torch.no_grad():
            whole = model(_t(x), _t(t), _t(enc))
            with sp.using_sp_axis(model, ax):
                local = model(sp.shard_rows(_t(x), ax), _t(t), _t(enc))
                got = all_gather(local, ax, dim=1)
    finally:
        sp.RING_THRESHOLD_TOKENS = saved
    return _first(m, (_np(got), _np(whole)))


def row_errors(mesh, kind, kw, params):
    """The messages of the row checks: ``spatial_decode`` of 14 latent rows
    and ``spatial_encode`` of a 72-row image over the pool's 4 ranks."""
    model = _codec(kind, kw, params)
    out = []
    for call in (lambda: sp.spatial_decode(model, torch.zeros(1, 14, 16, 4), mesh,
                                           method="decode"),
                 lambda: sp.spatial_encode(model, torch.zeros(1, 72, 64, 3), mesh)):
        try:
            call()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return _first(mesh, out)


# --- the 2.1 pipeline ---------------------------------------------------------


def _pipe(name, params, cfg, clip):
    """The port's 2.1 pipeline on this rank, built once per name (a task
    type, or "hires", a text2img pipeline of other parameters)."""
    from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
    from kandinsky2_tpu_torch.utils import stub_tokenizers

    if name not in _PIPES:
        tok1, tok2 = stub_tokenizers()
        task_type = "inpainting" if name == "inpainting" else "text2img"
        pipe = Kandinsky2_1(config=cfg, tokenizer1=tok1, tokenizer2=tok2,
                            clip_mean=clip[0], clip_std=clip[1],
                            task_type=task_type, dtype=torch.float32, device="cpu")
        pipe.load_jax_params(params)
        _PIPES[name] = pipe
    return _PIPES[name]


def pipeline(mesh, n, name, params, cfg, clip, entry, kw, seed=0):
    """``entry`` of the port's pipeline with ``sp_mesh`` over the first n
    ranks (float images, from rank 0), after ``set_seed(seed)`` on every
    rank; and the same call unsharded where ``n`` is 0."""
    pipe = _pipe(name, params, cfg, clip)
    m = mesh if n == 0 else sub_mesh(mesh, n)
    if m is None:
        return None
    kw = dict(kw, output="float")
    if n:
        kw["sp_mesh"] = m
    pipe.set_seed(seed)
    try:
        out = getattr(pipe, entry)(**kw)
    except ValueError as e:
        return _first(m, str(e))
    return _first(m, np.asarray(out))
