"""Decoder (unCLIP 2.1) fine-tuning CLI of the PyTorch port, the
counterpart of the repository's ``train_2_1_unclip.py``:

    python -m kandinsky2_tpu_torch.train.train_2_1_unclip \\
        --config train_configs/config_unclip_2_1.yaml [--device cuda]

It reads the same YAML.  ``run(cfg, device=...)`` does the work on a config
dict, so callers need no YAML parser; PyYAML is imported in ``main`` only.
The frozen encoders (MoVQ, XLM-R + MultilingualCLIP, CLIP ViT) run in
``prepare_batch`` under ``no_grad`` (trainer_2_1_uclip.py:14-37); the UNet
keeps fp32 parameters and computes in bf16, as the JAX CLI does.  Weights
are random unless ``params_path`` names a weight export of
``train/checkpoint.py``; the stub of ``utils.stub_tokenizers`` stands
in for XLM-R's tokenizer (a ``tokenizer_name`` raises: that sentencepiece
file needs ``transformers``).  With
``inpainting: true`` the UNet is the 9-channel inpainting one and each
batch carries random masks of ``train/masks.py`` at the latents' size
(drawn from the global ``np.random``, as the JAX CLI draws them) and the
latents times the mask.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..configs import CONFIG_2_1, deep_copy_config, small_config
from ..pipelines.kandinsky2_1 import Kandinsky2_1
from ..utils import stub_tokenizers
from .checkpoint import load_checkpoint
from .data import TextImageDataset, create_loader
from .masks import get_image_mask
from .optim import optimizer_from_config
from .train_unclip import train_unclip


def pipeline_config(cfg: dict) -> dict:
    """The pipeline config the YAML describes: ``CONFIG_2_1`` with the
    YAML's model, MoVQ and text-encoder sections, and its optional tower
    overrides (tiny configs for tests)."""
    pipe_cfg = deep_copy_config(CONFIG_2_1)
    pipe_cfg["model_config"].update(cfg["model_config"])
    pipe_cfg["image_enc_params"] = cfg["image_enc_params"]
    pipe_cfg["text_enc_params"].update(
        {k: v for k, v in cfg["text_enc_params"].items() if v})
    for key in ("clip_text_params", "clip_vision_params", "clip_image_size",
                "prior"):
        if key in cfg:
            pipe_cfg[key] = cfg[key]
    return pipe_cfg


def small_train_config(df_path: str, image_dir: str, save_path: str,
                       head_channels: int = 32, image_size: int = 64) -> dict:
    """``train_configs/config_unclip_2_1.yaml`` with every model at the
    ``bench.py --small`` widths (``configs.small_config``), a batch of 2 at
    ``image_size``², a save every 2 steps, and the CSV ``df_path`` of
    images under ``image_dir``."""
    small = small_config(head_channels)
    return {
        "params_path": None, "num_epochs": 1, "save_every": 2,
        "save_path": save_path, "inpainting": False, "remat": False,
        "parallel": None,
        "freeze": {"freeze_resblocks": True, "freeze_attention": False},
        "model_config": dict(small["model_config"], use_fp16=False),
        "diffusion_config": deep_copy_config(CONFIG_2_1["diffusion_config"]),
        "optim_params": {"name": "optax.adafactor",
                         "params": {"learning_rate": 5e-6}},
        "schedule_sampler": "uniform",
        **{k: small[k] for k in ("image_enc_params", "text_enc_params",
                                 "clip_text_params", "clip_vision_params",
                                 "clip_image_size", "prior")},
        "data": {"train": {
            "df_path": df_path, "image_dir": image_dir, "image_size": image_size,
            "tokenizer_name": None, "clip_image_size": small["clip_image_size"],
            "drop_text_prob": 0.5, "drop_image_prob": 0.1, "seq_len": 12,
            "batch_size": 2, "shuffle": True,
        }},
    }


def make_prepare_batch(pipe: Kandinsky2_1):
    """``prepare_batch(raw)``: the loader's numpy batch -> the train step's
    batch on the pipeline's device (scaled MoVQ latents, XLM-R full and
    pooled embeddings, CLIP image embedding; for an inpainting pipeline a
    random mask [B, h, w, 1] per latent and the masked latents).  Each
    frozen encoder runs inside its ``k21.*`` span, as in the pipeline."""
    dev = pipe.device
    inpainting = pipe.task_type == "inpainting"

    @torch.no_grad()
    def prepare_batch(raw: dict) -> dict:
        latents = pipe.movq_encode(raw["image"]) * pipe.scale
        with record_function("k21.text_encoder"):
            full, pooled = pipe.text_encoder(
                torch.as_tensor(raw["tokens"], device=dev).long(),
                torch.as_tensor(raw["mask"], device=dev))
        image_emb = pipe.encode_images(raw["clip_image"])
        batch = {"image_latents": latents, "full_emb": full,
                 "pooled_emb": pooled, "image_emb": image_emb}
        if inpainting:
            B, h, w = latents.shape[:3]
            mask = torch.from_numpy(get_image_mask(B, (h, w))[..., None].astype(np.float32))
            batch["inpaint_mask"] = mask.to(dev)
            batch["inpaint_image"] = latents * batch["inpaint_mask"]
        return batch

    return prepare_batch


def build_pipeline(cfg: dict, device="cuda") -> Kandinsky2_1:
    """The five-model pipeline with random fp32 parameters from seed 0 (and
    ``params_path`` loaded into the UNet), computing in bf16; its UNet is
    the inpainting one where ``cfg["inpainting"]``."""
    tok_name = cfg["data"]["train"].get("tokenizer_name")
    if tok_name:
        raise ValueError(
            f"tokenizer_name {tok_name!r}: the XLM-R tokenizer is a sentencepiece "
            "file that only transformers reads, which the port does without; "
            "leave tokenizer_name empty for the stand-in")
    tokenizer1 = stub_tokenizers(cfg["text_enc_params"].get("vocab_size", 250002))[0]
    pipe = Kandinsky2_1(config=pipeline_config(cfg), tokenizer1=tokenizer1,
                        task_type="inpainting" if cfg.get("inpainting") else "text2img",
                        dtype=torch.bfloat16, device=device)
    pipe.init_random_params(torch.Generator(device=device).manual_seed(0),
                            dtype=torch.float32)
    if cfg.get("params_path"):
        pipe.unet.load_state_dict(load_checkpoint(cfg["params_path"]))
    return pipe


def run(cfg: dict, device="cuda"):
    """Train as the YAML ``cfg`` says; returns the final ``TrainState``.

    ``parallel: {data: D, sp: S}`` spawns D·S ranks (``parallel.launch``)
    on ``device``: NCCL with one card a rank where there are D·S cards,
    else gloo (the ranks sharing the card, or on the CPU); each rank runs
    the spatial x data parallel step (``train_unclip(mesh_shape=(D, S))``)
    on the same batches, rank 0 writes the checkpoints, and ``run`` returns
    rank 0's ``{"step", "world"}``.  ``parallel: {fsdp: N}`` spawns N ranks
    the same way, each running the ZeRO-sharded step
    (``train_unclip(fsdp=N)``); as in the JAX CLI, ``fsdp`` wins over
    ``data`` and ``sp`` in the same mapping.  ``parallel`` must be a
    mapping: anything else raises TypeError before anything is built."""
    par = cfg.get("parallel")
    if par:
        if not isinstance(par, dict):
            raise TypeError(f"parallel: a mapping, {{data: D, sp: S}} or {{fsdp: N}}; "
                            f"got {par!r}")
        if "fsdp" in par:
            if par["fsdp"] is None:
                return _train(cfg, device)
            return run_parallel(cfg, device=device, fsdp=int(par["fsdp"]))
        return run_parallel(cfg, (int(par.get("data", 1)), int(par.get("sp", 1))),
                            device)
    return _train(cfg, device)


def run_parallel(cfg: dict, mesh_shape: Optional[tuple] = None, device="cuda",
                 fsdp: Optional[int] = None):
    """``run`` on a (data, sp) mesh of D·S ranks, or on ``fsdp`` ranks of
    the sharded state, spawned here under a deadline of a week; rank 0's
    summary."""
    from ..parallel.launch import RankPool

    world = fsdp if fsdp is not None else mesh_shape[0] * mesh_shape[1]
    backend = ("nccl" if device == "cuda" and torch.cuda.device_count() >= world
               else "gloo")
    with RankPool(world, backend, device=device) as pool:
        return pool.run(_train_rank, cfg, mesh_shape, device, fsdp,
                        timeout=7 * 86400.0)[0]


def _train_rank(mesh, cfg: dict, mesh_shape, device: str, fsdp=None) -> dict:
    """One rank of ``run_parallel``: the same seeded masks on every rank."""
    np.random.seed(0)
    state = _train(cfg, device, tuple(mesh_shape) if mesh_shape else None, fsdp)
    world = fsdp if fsdp is not None else mesh_shape[0] * mesh_shape[1]
    return {"step": None if state is None else state.step, "world": world}


def _train(cfg: dict, device, mesh_shape=None, fsdp=None):
    optimizer_factory = optimizer_from_config(cfg["optim_params"])
    pipe = build_pipeline(cfg, device)
    dtr = cfg["data"]["train"]
    dataset = TextImageDataset(
        csv_path=dtr["df_path"], image_dir=dtr.get("image_dir", ""),
        tokenizer=pipe.tokenizer1,
        clip_image_size=dtr.get("clip_image_size", 224),
        image_size=dtr.get("image_size", 512),
        drop_text_prob=dtr.get("drop_text_prob", 0.5),
        drop_image_prob=dtr.get("drop_image_prob", 0.1),
        seq_len=dtr.get("seq_len", 77),
    )
    loader = create_loader(dataset, batch_size=dtr.get("batch_size", 1),
                           shuffle=dtr.get("shuffle", True))
    return train_unclip(
        unet=pipe.unet, diffusion_config=cfg["diffusion_config"], loader=loader,
        prepare_batch=make_prepare_batch(pipe),
        optimizer_factory=optimizer_factory,
        num_epochs=cfg.get("num_epochs", 1),
        save_every=cfg.get("save_every", 1000),
        save_path=cfg.get("save_path", "checkpoints/unclip"),
        schedule_sampler=cfg.get("schedule_sampler", "uniform"),
        freeze_resblocks=cfg["freeze"]["freeze_resblocks"],
        freeze_attention=cfg["freeze"]["freeze_attention"],
        remat=bool(cfg.get("remat", False)),
        accum_steps=int(cfg.get("accum_steps", 1)),
        mesh_shape=mesh_shape,
        fsdp=fsdp,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    import yaml

    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    run(cfg, device=args.device)


if __name__ == "__main__":
    main()
