"""Spatially parallel MoVQ decode: image rows sharded over ranks, one
process a shard (the port of examples/highres_sp_decode.py).

One card decodes a 4096² image only if the decoder's activations fit it;
``parallel.spatial.spatial_decode`` shards the rows over the ranks: every
3x3 convolution takes one-row halos from its neighbours, the norms' K1
moments are combined over the ranks before K2 applies them, and the
bottleneck attention gathers keys and values, or above 65,536 tokens
passes them around a ring of K3 launches whose partial softmaxes are
merged.  The result is the single-card decoder's.

    python -m kandinsky2_tpu_torch.examples.highres_sp_decode --res 1024 --world 4
    python -m kandinsky2_tpu_torch.examples.highres_sp_decode --full --res 4096

``--full`` is the 67M-parameter MoVQ of the checkpoints (random weights),
else a demo-size codec; ``--small`` a 64² decode of the demo codec.
``--world`` ranks share the card over gloo (``--device cpu``: the CPU).
"""

from __future__ import annotations

import argparse
import time

# the demo-size codec of the JAX script
DEMO = {"z_channels": 4, "embed_dim": 4, "n_embed": 256, "ch": 32,
        "ch_mult": (1, 2, 2, 4), "num_res_blocks": 1, "attn_resolutions": (32,),
        "resolution": 256}


def build_movq(full: bool, device: str, dtype):
    """The MoVQ (the checkpoints' 67M config with ``full``, else the demo
    one) with seeded random weights, computing in ``dtype``: its
    convolutions and norms do not depend on the resolution, so it decodes
    any size."""
    import torch

    from ..models.movq import MOVQ
    from ..pipelines.base import init_random_

    movq = MOVQ(**({} if full else DEMO), dtype=dtype, device=device)
    init_random_(movq, torch.Generator(device=device).manual_seed(0))
    return movq.to(dtype)


def decode_rank(mesh, res: int, full: bool, device: str, impl=None,
                keep_image: bool = True):
    """One rank's part of the decode of random codes at ``res``²: returns
    the seconds of the decode, this rank's peak device memory and, where
    ``keep_image``, the image (the same on every rank) as a float CPU
    tensor on rank 0; else the image on this rank's device under
    "device_image".  ``impl`` forces the bottleneck attention's
    "gathered" or "ring" path (None: by the threshold)."""
    import torch

    from ..parallel import spatial

    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    movq = build_movq(full, device, dtype)
    lat = res // 8
    g = torch.Generator(device=device).manual_seed(1)
    codes = torch.randint(0, movq.quantize.embedding.num_embeddings, (1, lat, lat),
                          generator=g, device=device)
    saved = spatial.RING_THRESHOLD_TOKENS
    if impl is not None:
        spatial.RING_THRESHOLD_TOKENS = 1 if impl == "ring" else 2**62
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        with torch.inference_mode():
            img = spatial.spatial_decode(movq, codes, mesh)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        spatial.RING_THRESHOLD_TOKENS = saved
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    out = {"seconds": seconds, "peak_bytes": peak}
    if not keep_image:
        return dict(out, device_image=img)
    return dict(out, image=img.float().cpu() if mesh.axis().index == 0 else None)


def main(argv=None):
    import numpy as np

    from ..parallel.launch import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512, help="output resolution")
    ap.add_argument("--full", action="store_true",
                    help="real 67M MoVQ config instead of the demo-size one")
    ap.add_argument("--small", action="store_true",
                    help="a 64² decode of the demo codec")
    ap.add_argument("--world", type=int, default=4,
                    help="ranks, each a row shard (in place of the JAX script's --cpu N)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = 64 if args.small else args.res
    if (res // 8) % args.world:
        raise SystemExit(f"latent rows {res // 8} must divide {args.world}")
    print(f"{args.world} ranks on {args.device}, image rows sharded {args.world}-way")
    out = run_ranks(decode_rank, args.world, res, args.full, args.device,
                    device=args.device)
    img = out[0]["image"].numpy()
    finite = bool(np.isfinite(img).all())
    print(f"decoded {res}²x{img.shape[-1]} in {max(r['seconds'] for r in out):.1f}s; "
          f"finite={finite}")
    assert finite and img.shape == (1, res, res, 3)


if __name__ == "__main__":
    main()
