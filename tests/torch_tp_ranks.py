"""The rank side of ``test_torch_tensor_parallel.py``: functions that every
rank of a ``parallel.launch.RankPool`` runs as ``fn(mesh, ...)``, in fp32
on the CPU.  Each builds what it shards from the numpy arrays it is handed
(JAX's parameters as numpy trees) or from a torch seed, runs it unsharded
and tensor-parallel, and returns numpy arrays.  This module imports no
JAX."""

import contextlib

import torch

from kandinsky2_tpu_torch.parallel import mesh as mesh_mod
from kandinsky2_tpu_torch.parallel import tensor_parallel as tp
from kandinsky2_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    ShardingReport,
    make_mesh,
    shard_params,
)


def _report(rep: ShardingReport) -> dict:
    return dict(sharded_params=rep.sharded_params, replicated_params=rep.replicated_params,
                sharded_bytes=rep.sharded_bytes, total_bytes=rep.total_bytes,
                candidate_bytes=rep.candidate_bytes, fallbacks=list(rep.fallbacks),
                summary=rep.summary())


# --- the mesh --------------------------------------------------------------------


def meshes(mesh):
    """``make_mesh`` over the pool's 4 ranks: {case: (mesh shape, this
    rank's (data, model) index) or None outside the mesh}."""
    cases = {"default": {}, "mp 2": dict(model_parallel=2),
             "mp 3 halves to 1": dict(model_parallel=3),
             "first 2": dict(n_devices=2), "ranks 1, 3": dict(devices=[1, 3]),
             "mp 8 halves to 4": dict(model_parallel=8)}
    out = {}
    for name, kw in cases.items():
        m = make_mesh(**kw)
        out[name] = None if m is None else (
            tuple(m.shape.values()), (m.axis("data").index, m.axis("model").index),
            m.axis("model").ranks)
    return out


def coverage_guard(mesh):
    """JAX's guard test on the port: a large Linear whose dims the model
    axis does not divide falls back to replication, and
    ``min_candidate_frac`` makes that raise.  (report fields, the error)."""
    grid = make_mesh(model_parallel=4)
    model = torch.nn.Module()
    model.layer = torch.nn.Module()
    from kandinsky2_tpu_torch.models.layers import Linear

    model.layer.qkv = Linear(258, 2050, bias=False)
    rep = ShardingReport()
    shard_params(model, grid, min_size=64, report=rep)
    try:
        shard_params(model, grid, min_size=64, min_candidate_frac=0.5)
        err = None
    except ValueError as e:
        err = str(e)
    return _report(rep), err


# --- the sharded layers ------------------------------------------------------------


def layers(mesh, mp, seed):
    """Each sharded form against its layer unsharded at ``mp`` ranks of the
    model axis (fp32): {form: (max abs err, max abs output, output shape,
    weight shape, whether ``full_weight`` gives back the whole weight)}
    from the mesh's first rank (every rank of the mesh gets the same
    output)."""
    from kandinsky2_tpu_torch.models.layers import Conv2d, Linear

    grid = make_mesh(n_devices=mp, model_parallel=mp)
    if grid is None:
        return None
    ax = grid.axis("model")
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, std=1.0):
        return torch.randn(shape, generator=g) * std

    x = rand(2, 5, 48)
    img = rand(2, 6, 6, 48).contiguous(memory_format=torch.channels_last)
    ids = torch.randint(0, 64, (2, 7), generator=g)
    cases = {
        "column linear": (lambda: Linear(48, 64), 0, x),
        "row linear": (lambda: Linear(48, 64), 1, x),
        "column conv": (lambda: Conv2d(48, 32), 0, img),
        "row conv": (lambda: Conv2d(48, 32), 1, img),
        "row conv 1x1 stride 2": (lambda: Conv2d(48, 32, 1, 2, 0), 1, img),
        "column embedding": (lambda: torch.nn.Embedding(64, 32), 1, ids),
        "row embedding": (lambda: torch.nn.Embedding(64, 32), 0, ids),
    }
    errs = {}
    for name, (make, dim, inp) in cases.items():
        layer = make()
        with torch.no_grad():
            for p in layer.parameters():  # weights ~ N(0, 1/fan_in), as the models'
                p.copy_(rand(*p.shape, std=p[0].numel() ** -0.5 if p.dim() > 1 else 0.1))
        with torch.no_grad():
            weight = layer.weight.clone()
            whole = layer(inp)
            tp.shard_layer_(layer, dim, ax, name)
            got = layer(inp)
            regathered = torch.equal(tp.full_weight(layer), weight)
        errs[name] = (float((got - whole).abs().max()), float(whole.abs().max()),
                      tuple(got.shape), tuple(layer.weight.shape), regathered)
    return errs if ax.index == 0 else None


# --- the pipelines -------------------------------------------------------------------


def _pipe(spec, params):
    """The port's pipeline of ``spec`` ({"version", "config", "clip"}) on
    JAX's numpy parameters, fp32 on the CPU."""
    version, cfg = spec["version"], spec["config"]
    if version == "2.1":
        from kandinsky2_tpu_torch.pipelines import Kandinsky2_1
        from kandinsky2_tpu_torch.utils import stub_tokenizers

        tok1, tok2 = stub_tokenizers()
        mean, std = spec["clip"]
        pipe = Kandinsky2_1(config=cfg, tokenizer1=tok1, tokenizer2=tok2, clip_mean=mean,
                            clip_std=std, dtype=torch.float32, device="cpu")
    elif version == "2.2":
        from kandinsky2_tpu_torch.pipelines import Kandinsky2_2
        from kandinsky2_tpu_torch.utils import stub_tokenizer22

        pipe = Kandinsky2_2(tokenizer=stub_tokenizer22(cfg["text_encoder"]["vocab_size"]),
                            dtype=torch.float32, overrides=cfg, device="cpu")
    else:
        from kandinsky2_tpu_torch.pipelines import Kandinsky2
        from kandinsky2_tpu_torch.utils import stub_tokenizers

        tok, _ = stub_tokenizers(64)
        pipe = Kandinsky2(config=cfg, tokenizer1=tok, tokenizer2=tok, dtype=torch.float32,
                          device="cpu")
    pipe.load_jax_params(params)
    return pipe


def _with_latents(pipe):
    """``pipe`` keeping the latents of its decodes in ``pipe.seen``."""
    pipe.seen = []
    inner = pipe._decode

    def decode(latents):
        pipe.seen.append(latents.detach().float().numpy().copy())
        return inner(latents)

    pipe._decode = decode
    return pipe


@contextlib.contextmanager
def columns_only():
    """The rule without its row-parallel specs (those kernels stay whole):
    every sharded layer is then column-parallel, which reorders no sum."""
    rule = mesh_mod._param_spec

    def spec(path, arr, min_size=1024):
        s = rule(path, arr, min_size)
        return mesh_mod.P() if s and s[-1] is None and MODEL_AXIS in s else s

    mesh_mod._param_spec = spec
    try:
        yield
    finally:
        mesh_mod._param_spec = rule


def _sharded_t2i(spec, params, kw, model):
    pipe = _with_latents(_pipe(spec, params))
    grid = make_mesh(model_parallel=model)
    pipe.shard(grid, min_size=64, verbose=False)
    tp.reset_collective_counts()
    img = pipe.generate_text2img(**kw)
    return pipe, grid, img, tp.collective_counts()


def text2img_all(mesh, cases, shapes):
    """For each version of ``cases`` ({version: (spec, params, kw)}):
    ``generate_text2img(**kw)`` of the port's pipeline unsharded (rank 0
    only: "whole"), then after ``shard(min_size=64)`` on each (data, model)
    mesh of ``shapes`` (a fresh pipeline each), with the latents, the
    report, the collectives of the call and the error of ``sp_mesh=`` on
    the sharded pipeline; and ("columns") the latents and image with the
    row-parallel specs left out, on the first mesh."""
    out = {}
    with torch.no_grad():
        for version, (spec, params, kw) in cases.items():
            kw = dict(kw, output="float")
            res = out[version] = {}
            if mesh.axis().index == 0:
                pipe = _with_latents(_pipe(spec, params))
                img = pipe.generate_text2img(**kw)
                res["whole"] = (pipe.seen[-1], img)
            for data, model in shapes:
                pipe, grid, img, counts = _sharded_t2i(spec, params, kw, model)
                try:
                    pipe.decode_latents(pipe.seen[-1], sp_mesh=grid)
                    refused = ""
                except ValueError as e:
                    refused = str(e)
                res[(data, model)] = (pipe.seen[-1], img, _report(pipe.sharding_report),
                                      counts, refused)
            with columns_only():
                pipe, _, img, _ = _sharded_t2i(spec, params, kw, shapes[0][1])
            res["columns"] = (pipe.seen[-1], img, pipe.sharding_report.sharded_params)
    return out


def _loras(unet, seed):
    """LoRA factors of ``unet`` (unsharded) from ``seed``, ``up`` drawn
    too, so that the adapter changes the image."""
    from kandinsky2_tpu_torch.models.lora import init_lora

    g = torch.Generator().manual_seed(seed)
    loras = init_lora(unet, g)
    for f in loras.values():
        f["up"] = 0.5 * torch.randn(f["up"].shape, generator=g)
    return loras


def serve(mesh, spec, params, kw, lora_seed, seed):
    """JAX's serving test on the sharded 2.1 pipeline: two prompts through
    ``GenerationServer(max_batch=2)``, then one request with a LoRA
    adapter (drawn from ``lora_seed`` on the unsharded UNet, the same on
    every rank) from ``set_seed(seed)``, the same request answered by the
    unsharded pipeline's server first (rank 0).  (the two images, the LoRA
    image sharded and unsharded, the stats, the adapter's targets)."""
    from kandinsky2_tpu_torch.serving import GenerationServer

    def lora_image(pipe):
        server = GenerationServer(pipe, max_batch=2)
        server.attach_lora("style", loras)
        server.start()
        try:
            imgs = []
            if pipe.mesh is not None:
                futs = [server.submit(p, **kw) for p in ("a red cat", "a blue dog")]
                imgs = [f.result(timeout=120)[0] for f in futs]
            pipe.set_seed(seed)
            img = server.submit("a red cat", lora="style", **kw).result(timeout=120)[0]
            return imgs, img, server.stats()
        finally:
            server.stop()

    kw = dict(kw, output="float")
    whole = None
    with torch.no_grad():
        pipe = _pipe(spec, params)
        loras = _loras(pipe.unet, lora_seed)
        if mesh.axis().index == 0:
            _, whole, _ = lora_image(pipe)
            pipe = _pipe(spec, params)
        pipe.shard(make_mesh(model_parallel=4), min_size=64, verbose=False)
        imgs, got, stats = lora_image(pipe)
    return imgs, got, whole, stats, sorted(loras)

