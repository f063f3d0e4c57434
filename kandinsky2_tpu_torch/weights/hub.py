"""Where the published checkpoints lie in a local cache, the cache-only
counterpart of ``kandinsky2_tpu/weights/hub.py``.

Files are looked up under ``<cache_dir>/<version>/...`` in the JAX
package's layout (the torch reference's), so a cache that the JAX package
or the reference filled is used as it is.  The port downloads nothing: a
file that is not in the cache raises ``FileNotFoundError`` naming the file
and the repo or URL it comes from.
"""

from __future__ import annotations

import os

REPO_2_0 = "sberbank-ai/Kandinsky_2.0"
REPO_2_1 = "sberbank-ai/Kandinsky_2.1"

# what a text encoder directory of the 2.0 and 2.1 repos holds; the port
# reads its pytorch_model.bin (its tokenizer files need ``transformers``, so
# build_kandinsky21 and build_kandinsky20 take the tokenizers as arguments)
TEXT_ENCODER_FILES = [
    "config.json",
    "pytorch_model.bin",
    "sentencepiece.bpe.model",
    "special_tokens_map.json",
    "tokenizer.json",
    "tokenizer_config.json",
]

# OpenAI CLIP ViT-L/14, which the 2.1 pipeline loads (kandinsky2_1_model.py:64)
CLIP_VIT_L14_URL = (
    "https://openaipublic.azureedge.net/clip/models/"
    "b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt"
)
CLIP_BPE_URL = (
    "https://github.com/openai/CLIP/raw/main/clip/bpe_simple_vocab_16e6.txt.gz"
)

KANDINSKY_22_REPOS = {
    "prior": "kandinsky-community/kandinsky-2-2-prior",
    "decoder": "kandinsky-community/kandinsky-2-2-decoder",
    "decoder-inpaint": "kandinsky-community/kandinsky-2-2-decoder-inpaint",
    "controlnet-depth": "kandinsky-community/kandinsky-2-2-controlnet-depth",
}

# the decoder repo of each 2.2 task (kandinsky2_2_model.py:26-42): text2img,
# img2img and mix share the base decoder; inpainting and ControlNet-depth
# have their own UNets
_DECODER_KEY_BY_TASK = {
    "text2img": "decoder",
    "img2img": "decoder",
    "inpainting": "decoder-inpaint",
    "controlnet": "controlnet-depth",
}

# the files of each subfolder of the 2.2 snapshots; a tuple lists
# alternatives (safetensors exports, then the older .bin ones)
_PRIOR_SUBFOLDERS = {
    "prior": [
        "config.json",
        ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin"),
    ],
    "image_encoder": [
        "config.json",
        ("model.safetensors", "pytorch_model.bin"),
    ],
    "text_encoder": [
        "config.json",
        ("model.safetensors", "pytorch_model.bin"),
    ],
    "tokenizer": [
        "vocab.json",
        "merges.txt",
        "tokenizer_config.json",
        "special_tokens_map.json",
    ],
}
_DECODER_SUBFOLDERS = {
    "unet": [
        "config.json",
        ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin"),
    ],
    "movq": [
        "config.json",
        ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin"),
    ],
}

# the ControlNet-depth hint's depth network: the MiDaS hybrid the reference
# notebook runs (dpt_hybrid-midas), or the pure-ViT DPT-Large
DPT_REPO = "Intel/dpt-hybrid-midas"
DPT_LARGE_REPO = "Intel/dpt-large"


def cached_file(dest: str, source: str) -> str:
    """``dest``, which must be in the cache; ``source`` names where it
    comes from."""
    if not os.path.exists(dest):
        raise FileNotFoundError(
            f"{dest} is not in the cache (it comes from {source}); the port "
            "downloads nothing, so place the file there first")
    return dest


def _cached_any(dest_dir: str, names, source: str) -> str:
    """The first of ``names`` present in ``dest_dir``."""
    names = (names,) if isinstance(names, str) else tuple(names)
    for name in names:
        dest = os.path.join(dest_dir, os.path.basename(name))
        if os.path.exists(dest):
            return dest
    return cached_file(os.path.join(dest_dir, " or ".join(names)), source)


def _snapshot(repo_id: str, local_dir: str, manifest: dict) -> str:
    for subfolder, files in manifest.items():
        for entry in files:
            _cached_any(os.path.join(local_dir, subfolder), entry,
                        f"{repo_id}/{subfolder}")
    return local_dir


def fetch_2_1(cache_dir: str = "/tmp/kandinsky2", task_type: str = "text2img",
              use_auth_token=None) -> dict:
    """The cached 2.1 files (kandinsky2/__init__.py:100-158) as a dict of
    paths.  ``bpe``, the CLIP BPE vocabulary, is looked up only by
    ``build_kandinsky21`` given no CLIP tokenizer."""
    cd = os.path.join(cache_dir, "2_1")
    decoder = "decoder_fp16.ckpt" if task_type == "text2img" else "inpainting_fp16.ckpt"

    def hf(name):
        return cached_file(os.path.join(cd, name), f"{REPO_2_1}/{name}")

    paths = {
        "decoder": hf(decoder),
        "prior": hf("prior_fp16.ckpt"),
        "movq": hf("movq_final.ckpt"),
        "clip_stats": hf("ViT-L-14_stats.th"),
        "text_encoder": os.path.join(cd, "text_encoder"),
        "clip": cached_file(os.path.join(cd, "ViT-L-14.pt"), CLIP_VIT_L14_URL),
        "bpe": os.path.join(cd, "bpe_simple_vocab_16e6.txt.gz"),
    }
    hf("text_encoder/pytorch_model.bin")
    return paths


def fetch_2_0(cache_dir: str = "/tmp/kandinsky2", task_type: str = "text2img",
              use_auth_token=None) -> dict:
    """The cached 2.0 files (kandinsky2/__init__.py:12-84) as a dict of
    paths."""
    cd = os.path.join(cache_dir, "2_0")
    unet = "Kandinsky-2-0-inpainting.pt" if task_type == "inpainting" else "Kandinsky-2-0.pt"

    def hf(name):
        return cached_file(os.path.join(cd, name), f"{REPO_2_0}/{name}")

    paths = {
        "unet": hf(unet),
        "vae": hf("vae.ckpt"),
        "text_encoder1": os.path.join(cd, "text_encoder1"),
        "text_encoder2": os.path.join(cd, "text_encoder2"),
    }
    hf("text_encoder1/pytorch_model.bin")
    hf("text_encoder2/pytorch_model.bin")
    return paths


def fetch_dpt(cache_dir: str = "/tmp/kandinsky2", repo_id: str = DPT_REPO,
              use_auth_token=None) -> str:
    """The cached HF DPT snapshot (hybrid or pure ViT) for
    ``depth.dpt_estimator``: ``<cache_dir>/dpt/<repo_id with / as __>``."""
    local = os.path.join(cache_dir, "dpt", repo_id.replace("/", "__"))
    _cached_any(local, "config.json", repo_id)
    _cached_any(local, ("model.safetensors", "pytorch_model.bin"), repo_id)
    return local


def fetch_2_2(cache_dir: str = "/tmp/kandinsky2", task_type: str = "text2img",
              use_auth_token=None) -> dict:
    """The cached 2.2 diffusers snapshots the task needs (the reference
    ``from_pretrained``s the prior repo's image_encoder, text_encoder,
    tokenizer and prior and the decoder repo's unet and movq,
    kandinsky2_2_model.py:17-44), in ``<cache_dir>/2_2/{prior,
    <decoder key>}/<subfolder>``.  Returns ``{"prior_dir", "decoder_dir",
    "tokenizer_dir"}`` for ``load_kandinsky22.build_kandinsky22``."""
    if task_type not in _DECODER_KEY_BY_TASK:
        raise ValueError(f"unknown 2.2 task_type {task_type!r}; "
                         f"one of {sorted(_DECODER_KEY_BY_TASK)}")
    cd = os.path.join(cache_dir, "2_2")
    decoder_key = _DECODER_KEY_BY_TASK[task_type]
    prior_dir = _snapshot(KANDINSKY_22_REPOS["prior"], os.path.join(cd, "prior"),
                          _PRIOR_SUBFOLDERS)
    decoder_dir = _snapshot(KANDINSKY_22_REPOS[decoder_key],
                            os.path.join(cd, decoder_key), _DECODER_SUBFOLDERS)
    return {"prior_dir": prior_dir, "decoder_dir": decoder_dir,
            "tokenizer_dir": os.path.join(prior_dir, "tokenizer")}
