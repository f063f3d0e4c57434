"""Spatial x data parallel decoder training: latent ROWS sharded over the
mesh's "sp" axis, examples over "data", one process a rank
(``train.train_unclip.make_spdp_train_fn``; the port of
examples/train_sp.py).

Row sharding divides the UNet's activation memory by the sp size: every
3x3 convolution takes one-row halos from its neighbours, each GroupNorm's
statistics are combined over the ranks, the attention runs the local
query rows against the gathered keys and values (the ring above 65,536
tokens), and the backward runs each collective's transpose.  The
gradients are the single-card gradients of the whole batch, the same on
every rank, so the replicated Adafactor state stays equal.

    python -m kandinsky2_tpu_torch.examples.train_sp --data 2 --sp 4
    python -m kandinsky2_tpu_torch.examples.train_sp --full --res 768 --sp 4

``--full`` is the 1.22B UNet of ``CONFIG_2_1`` (random weights, fp32
parameters computing in bf16 on the card, with ``remat``), else the JAX
script's demo-size UNet.  The data·sp ranks share the card over gloo, or
take a card each over NCCL where there are that many (``--device cpu``:
gloo on the CPU).  ``--small``: a 64² run.  Synthetic batch here: swap in
MoVQ-encoded latents and text/CLIP embeddings for real tuning.
"""

from __future__ import annotations

import argparse
import time

# the demo-size UNet of the JAX script
DEMO = {"num_channels": 32, "num_res_blocks": 1, "channel_mult": "1,2",
        "attention_resolutions": "32", "num_head_channels": 16, "model_dim": 32,
        "text_encoder_in_dim1": 16, "text_encoder_in_dim2": 32,
        "image_encoder_in_dim": 32, "num_image_embs": 2}


def train_rank(mesh, data: int, sp: int, res: int, steps: int, full: bool,
               device: str) -> list:
    """One rank of the run: the UNet with seeded random weights, the
    seeded synthetic batch, ``steps`` spdp steps (Adafactor at 5e-6, the
    loss-second-moment sampler, no EMA, ``remat`` with ``full``).  Returns
    the lines rank 0 prints (empty on the others)."""
    import numpy as np
    import torch

    from ..configs import CONFIG_2_1, create_model, deep_copy_config
    from ..parallel.mesh import Mesh
    from ..pipelines.base import init_random_
    from ..train.optim import optimizer_from_config
    from ..train.train_unclip import make_spdp_train_fn

    grid = Mesh(None, ("data", "sp"), shape=(data, sp))
    cfg = deep_copy_config(CONFIG_2_1)
    mc = cfg["model_config"]
    if not full:
        mc.update(DEMO)
    mc["inpainting"] = False
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    unet = create_model(**mc, dtype=dtype, device=device)
    init_random_(unet, torch.Generator(device=device).manual_seed(0))
    lat = res // 8
    B = 2 * data
    rng = np.random.default_rng(0)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    batch = {
        "image_latents": to(rng.normal(size=(B, lat, lat, 4)) * 0.5),
        "full_emb": to(rng.normal(size=(B, 77, mc["text_encoder_in_dim1"]))),
        "pooled_emb": to(rng.normal(size=(B, mc["text_encoder_in_dim2"]))),
        "image_emb": to(rng.normal(size=(B, mc["image_encoder_in_dim"]))),
    }
    n_par = sum(p.numel() for p in unet.parameters())
    lines = [f"UNet {n_par / 1e6:.1f}M params, mesh {(data, sp)} (data x sp), "
             f"latent {lat}² rows sharded {sp}-way"]
    init_state, train_fn = make_spdp_train_fn(
        unet, cfg["diffusion_config"],
        optimizer_from_config({"name": "optax.adafactor",
                               "params": {"learning_rate": 5e-6}}),
        grid, schedule_sampler="loss-second-moment", ema_decay=None,
        remat=full)  # the full-size backward needs rematerialization
    state = init_state(seed=1)
    for _ in range(steps):
        t = time.time()
        metrics = train_fn(state, batch)
        m = {k: float(v) for k, v in metrics.items()}
        lines.append(f"step {state.step}: {m} ({time.time() - t:.2f}s)")
    return lines if grid.axis("data").index == grid.axis("sp").index == 0 else []


def main(argv=None):
    import torch

    from ..parallel.launch import run_ranks
    # by its module's name, so the spawned ranks find it when this script
    # runs as __main__
    from .train_sp import train_rank as rank_fn

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=int, default=1, help="data-parallel axis size")
    ap.add_argument("--sp", type=int, default=1, help="spatial (row) axis size")
    ap.add_argument("--res", type=int, default=128, help="training image res "
                    "(latent = res/8; latent rows must divide sp*2^3)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--full", action="store_true",
                    help="real 1.22B UNet config instead of the demo-size one")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--small", action="store_true", help="a 64² run")
    args = ap.parse_args(argv)

    res = 64 if args.small else args.res
    lat = res // 8
    levels = 4 if args.full else len(DEMO["channel_mult"].split(","))
    need = args.sp * 2 ** (levels - 1)
    if lat % need:
        raise SystemExit(f"latent height {lat} must divide sp*2^(levels-1) = {need}")
    world = args.data * args.sp
    backend = ("nccl" if args.device == "cuda" and torch.cuda.device_count() >= world
               else "gloo")
    lines = run_ranks(rank_fn, world, args.data, args.sp, res, args.steps, args.full,
                      args.device, backend=backend, device=args.device, timeout=3600.0)[0]
    for line in lines:
        print(line, flush=True)
    print("SP training OK")


if __name__ == "__main__":
    main()
