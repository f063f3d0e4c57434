"""Prior fine-tuning CLI of the PyTorch port, the counterpart of the
repository's ``train_prior.py``:

    python -m kandinsky2_tpu_torch.train.train_prior_cli \\
        --config train_configs/config_prior.yaml [--device cuda]

It reads the same YAML.  ``run(cfg, device=...)`` does the work on a config
dict, so callers need no YAML parser; PyYAML is imported in ``main`` only.
The ``PriorTransformer`` comes from ``model_config.model.hparams`` with
fp32 parameters computing in bf16, the frozen OpenAI CLIP text tower and
ViT (``models/text_encoders.py``) at their default widths run in
``prepare_batch`` under ``no_grad``, and the train target is the
clip_mean/std-normalised image embedding (trainer_prior.py:44-51).
Weights are random from fixed seeds unless ``params_path`` names a weight
export of ``train/checkpoint.py``; clip_mean and clip_std are zeros and
ones unless ``clip_mean_std_path`` names a saved (mean, std) pair.

Without ``bpe_path`` the BPE stand-in of ``utils.stub_tokenizers`` takes
the CLIP tokenizer's place, as the decoder CLI's stand-in does for XLM-R's;
the JAX CLI has no such branch and needs the vocabulary file.
"""

from __future__ import annotations

import argparse

import torch

from ..models.prior import PriorTransformer
from ..models.text_encoders import CLIPTextTower, CLIPViT
from ..pipelines.base import init_random_
from ..tokenizers import CLIPBPETokenizer
from ..utils import stub_tokenizers
from .checkpoint import load_checkpoint
from .data import TextImageDataset, create_loader
from .optim import adafactor_from_config
from .train_prior import train_prior


def build_prior(cfg: dict, device="cuda") -> PriorTransformer:
    """The prior of ``cfg``'s hparams, random from seed 0 (or
    ``params_path``), fp32 parameters computing in bf16."""
    hp = cfg["model_config"]["model"]["hparams"]
    prior = PriorTransformer(
        text_ctx=hp["text_ctx"], xf_width=hp["xf_width"], xf_layers=hp["xf_layers"],
        xf_heads=hp["xf_heads"], xf_final_ln=hp["xf_final_ln"],
        clip_dim=hp["clip_dim"], clip_xf_width=hp["clip_xf_width"],
        dtype=torch.bfloat16, device=device)
    init_random_(prior, torch.Generator(device=device).manual_seed(0))
    if cfg.get("params_path"):
        prior.load_state_dict(load_checkpoint(cfg["params_path"]))
    return prior


def make_prepare_batch(cfg: dict, device="cuda"):
    """``prepare_batch(raw)``: the loader's numpy batch -> the prior step's
    batch on ``device``, through the frozen CLIP text tower and ViT (random
    from seeds 1 and 2, bf16 compute)."""
    hp = cfg["model_config"]["model"]["hparams"]
    text = CLIPTextTower(dtype=torch.bfloat16, device=device)
    vision = CLIPViT(dtype=torch.bfloat16, device=device)
    for seed, tower in ((1, text), (2, vision)):
        init_random_(tower, torch.Generator(device=device).manual_seed(seed))
        tower.requires_grad_(False)
    if cfg.get("clip_mean_std_path"):
        mean, std = torch.load(cfg["clip_mean_std_path"], map_location="cpu",
                               weights_only=True)
    else:
        mean, std = torch.zeros(hp["clip_dim"]), torch.ones(hp["clip_dim"])
    mean, std = (v.float().to(device)[None] for v in (mean, std))

    @torch.no_grad()
    def prepare_batch(raw: dict) -> dict:
        seq, feat = text(torch.as_tensor(raw["tokens"], device=device).long())
        image_emb = vision(torch.as_tensor(raw["clip_image"], device=device))
        return {"image_emb": (image_emb - mean) / std, "txt_feat": feat,
                "txt_feat_seq": seq,
                "mask": torch.as_tensor(raw["mask"], device=device)}

    return prepare_batch


def make_loader(cfg: dict):
    """The prior-mode CSV loader of ``cfg["data"]["train"]``."""
    dtr = cfg["data"]["train"]
    tokenizer = (CLIPBPETokenizer(cfg["bpe_path"]) if cfg.get("bpe_path")
                 else stub_tokenizers()[1])
    dataset = TextImageDataset(
        csv_path=dtr["df_path"], image_dir=dtr.get("image_dir", ""),
        tokenizer=tokenizer, clip_image_size=dtr.get("clip_image_size", 224),
        drop_text_prob=dtr.get("drop_text_prob", 0.1),
        seq_len=cfg["model_config"]["model"]["hparams"]["text_ctx"], mode="prior")
    return create_loader(dataset, batch_size=dtr.get("batch_size", 1),
                         shuffle=dtr.get("shuffle", True))


def run(cfg: dict, device="cuda"):
    """Train as the YAML ``cfg`` says; returns the final ``TrainState``."""
    optimizer_factory = adafactor_from_config(cfg["optim_params"])
    return train_prior(
        prior=build_prior(cfg, device), diffusion_config=cfg["model_config"]["diffusion"],
        loader=make_loader(cfg), prepare_batch=make_prepare_batch(cfg, device),
        optimizer_factory=optimizer_factory, num_epochs=cfg.get("num_epochs", 1),
        save_every=cfg.get("save_every", 1000),
        save_path=cfg.get("save_path", "checkpoints/prior"))


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
