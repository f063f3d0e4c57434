"""LPIPS (Learned Perceptual Image Patch Similarity, AlexNet variant) in
PyTorch, the counterpart of ``kandinsky2_tpu/lpips.py``: the BASELINE
acceptance metric (LPIPS < 0.02 against the torch reference at a fixed
seed) without the ``lpips`` or ``torchvision`` packages.

Formula (Zhang et al. 2018, v0.1 'alex' weights):

    d(a, b) = sum_l  mean_{h,w}  sum_c  w_l[c] * (na_l - nb_l)^2[c, h, w]

where ``na_l``/``nb_l`` are the channel-unit-normalised AlexNet feature
maps of the two images at the five ReLU taps and ``w_l`` the trained
non-negative linear heads.  Images are RGB in [-1, 1], NHWC at the
interface as everywhere in the port; the network runs NCHW (``F.conv2d``,
``F.max_pool2d(3, 2)``).

Parameters are a flat {name: tensor} dict in torchvision's layout:
``features.{0,3,6,8,10}.weight`` [out, in, kh, kw] and ``.bias``, and
``lin{0..4}.weight`` [ch].  ``save_lpips_weights`` / ``load_lpips_weights``
read and write the JAX package's safetensors file (``features.K.kernel``
HWIO, ``features.K.bias``, ``lin{i}.weight``, all fp32), so one converted
file serves both packages.  Converter CLI:

    python -m kandinsky2_tpu_torch.lpips --alex alexnet.pth --lin lpips_alex.pth \\
        --out lpips_alex.safetensors
    python -m kandinsky2_tpu_torch.lpips --weights lpips_alex.safetensors \\
        --images a.png b.png          # prints the distance
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .weights.safetensors_file import load_file, save_file

# published input normalisation constants (lpips ScalingLayer buffers)
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet feature stack: (layer key, out_ch, kernel, stride, pad,
# maxpool-before?).  Taps are the post-ReLU activations of each conv.
_CONVS = (
    ("features.0", 64, 11, 4, 2, False),
    ("features.3", 192, 5, 1, 2, True),
    ("features.6", 384, 3, 1, 1, True),
    ("features.8", 256, 3, 1, 1, False),
    ("features.10", 256, 3, 1, 1, False),
)
CHANNELS = tuple(c[1] for c in _CONVS)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def alexnet_features(params: Dict[str, torch.Tensor], x: torch.Tensor
                     ) -> List[torch.Tensor]:
    """Five tapped AlexNet feature maps (NCHW) of NCHW images in [-1, 1]."""
    shift = torch.as_tensor(SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.as_tensor(SCALE, device=x.device).view(1, 3, 1, 1)
    h = (x - shift) / scale
    feats = []
    for key, _, _, stride, pad, pool_before in _CONVS:
        if pool_before:
            h = F.max_pool2d(h, 3, 2)
        h = F.relu(F.conv2d(h, params[f"{key}.weight"], params[f"{key}.bias"],
                            stride=stride, padding=pad))
        feats.append(h)
    return feats


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Channel-unit normalisation (lpips normalize_tensor: /(||f||+eps))."""
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)


@torch.inference_mode()
def lpips_distance(params: Dict[str, torch.Tensor], a, b) -> torch.Tensor:
    """LPIPS distance per batch row of NHWC RGB images in [-1, 1] (arrays
    or tensors), on the device of ``params``, in fp32."""
    dev = params["lin0.weight"].device
    to = lambda im: torch.as_tensor(im, dtype=torch.float32, device=dev
                                    ).permute(0, 3, 1, 2)
    fa = alexnet_features(params, to(a))
    fb = alexnet_features(params, to(b))
    total = 0.0
    for i, (x, y) in enumerate(zip(fa, fb)):
        d = torch.square(_unit_normalize(x) - _unit_normalize(y))
        w = params[f"lin{i}.weight"].view(1, -1, 1, 1)  # non-negative
        total = total + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
    return total


def lpips_images(params: Dict[str, torch.Tensor], img_a, img_b) -> float:
    """LPIPS between two PIL images / HWC uint8 arrays."""
    to = lambda im: np.asarray(im, np.float32)[None] / 127.5 - 1.0
    return float(lpips_distance(params, to(img_a), to(img_b))[0])


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def init_random_lpips(generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random LPIPS weights drawn from ``generator``, on its device: kernels
    and biases N(0, 0.05²), heads U(0, 0.1) (tests and oracle
    comparisons)."""
    dev = generator.device
    normal = lambda *shape: 0.05 * torch.randn(shape, generator=generator, device=dev)
    params = {}
    in_ch = 3
    for key, out_ch, k, _, _, _ in _CONVS:
        params[f"{key}.weight"] = normal(out_ch, in_ch, k, k)
        params[f"{key}.bias"] = normal(out_ch)
        in_ch = out_ch
    for i, ch in enumerate(CHANNELS):
        params[f"lin{i}.weight"] = 0.1 * torch.rand((ch,), generator=generator,
                                                    device=dev)
    return params


def _to_np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t.astype(np.float32)
    return t.detach().cpu().float().numpy()


def convert_lpips_state_dicts(alex_sd: Dict, lin_sd: Dict) -> Dict[str, torch.Tensor]:
    """torchvision alexnet state_dict + lpips lin-head state_dict -> the
    port's parameters (fp32 CPU tensors).

    ``alex_sd``: features.{0,3,6,8,10}.{weight,bias}, conv weights OIHW.
    ``lin_sd``: lin{i}.model.1.weight (or lins.{i}.model.1.weight) of shape
    [1, ch, 1, 1].
    """
    params = {}
    for key, out_ch, k, _, _, _ in _CONVS:
        w = _to_np(alex_sd[f"{key}.weight"])
        if w.shape[:2] != (out_ch, w.shape[1]) or w.shape[2] != k:
            raise ValueError(f"unexpected {key}.weight shape {w.shape}")
        params[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        params[f"{key}.bias"] = torch.from_numpy(_to_np(alex_sd[f"{key}.bias"]))
    for i, ch in enumerate(CHANNELS):
        for lk in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if lk in lin_sd:
                w = _to_np(lin_sd[lk]).reshape(-1)
                break
        else:
            raise KeyError(f"lin{i} head not found in lin state dict")
        if w.shape != (ch,):
            raise ValueError(f"lin{i} head has {w.shape[0]} ch, wanted {ch}")
        if (w < 0).any():
            # the paper constrains heads non-negative; a negative value means
            # a wrong file, not a valid metric
            raise ValueError(f"lin{i} head has negative weights")
        params[f"lin{i}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
    return params


def save_lpips_weights(params: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``params`` as the JAX package's file: ``features.K.kernel``
    HWIO, ``features.K.bias``, ``lin{i}.weight``, fp32."""
    flat = {}
    for name, t in params.items():
        arr = _to_np(t)
        if name.startswith("features.") and name.endswith(".weight"):
            name, arr = name[:-len("weight")] + "kernel", arr.transpose(2, 3, 1, 0)
        flat[name] = np.ascontiguousarray(arr, np.float32)
    save_file(flat, path)


def load_lpips_weights(path: str, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's parameters from a file of ``save_lpips_weights`` (or of
    the JAX package's), on ``device``."""
    params = {}
    for name, arr in load_file(path).items():
        if name.endswith(".kernel"):
            name, arr = name[:-len("kernel")] + "weight", arr.transpose(3, 2, 0, 1)
        params[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    expected = {f"{c[0]}.{leaf}" for c in _CONVS for leaf in ("weight", "bias")} | {
        f"lin{i}.weight" for i in range(5)}
    missing = expected - set(params)
    if missing:
        raise KeyError(f"LPIPS weights file {path} missing {sorted(missing)}")
    return params


def _unwrap_lpips_sd(sd) -> Dict:
    """Normalise a torch.load result to a flat tensor dict: a plain
    state_dict, a pickled module (through its ``state_dict()``), or a full
    ``lpips.LPIPS`` checkpoint, whose backbone keys ``net.sliceK.IDX.*``
    map back to torchvision's ``features.IDX.*`` so that one file serves as
    both the alexnet and the lin input."""
    if hasattr(sd, "state_dict") and callable(sd.state_dict):
        sd = sd.state_dict()
    out = {}
    for k, v in sd.items():
        if k.startswith("net.slice"):
            k = "features." + k.split(".", 2)[2]
        out[k] = v
    return out


def convert_torch_files(alex_path: str, lin_path: str, out_path: str) -> None:
    """Convert torch LPIPS weights to the safetensors file.  Each input may
    be a state_dict, a pickled module, or a full ``lpips.LPIPS`` checkpoint
    (the same file for both paths in that case)."""
    alex_sd = _unwrap_lpips_sd(
        torch.load(alex_path, map_location="cpu", weights_only=False))
    lin_sd = _unwrap_lpips_sd(
        torch.load(lin_path, map_location="cpu", weights_only=False))
    save_lpips_weights(convert_lpips_state_dicts(alex_sd, lin_sd), out_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kandinsky2_tpu_torch.lpips",
        description="convert LPIPS torch weights / compute LPIPS",
    )
    ap.add_argument("--alex", help="torchvision alexnet state_dict (.pth)")
    ap.add_argument("--lin", help="lpips package lin-head file (alex.pth)")
    ap.add_argument("--out", help="output safetensors path for --alex/--lin")
    ap.add_argument("--weights", help="converted safetensors weights")
    ap.add_argument("--images", nargs=2, metavar=("A", "B"),
                    help="two image paths to score")
    ap.add_argument("--device", default="cuda", help="where to score (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.alex and args.lin and args.out:
        convert_torch_files(args.alex, args.lin, args.out)
        print(json.dumps({"written": args.out}))
        return 0
    if args.weights and args.images:
        from PIL import Image

        params = load_lpips_weights(args.weights, args.device)
        a = Image.open(args.images[0]).convert("RGB")
        b = Image.open(args.images[1]).convert("RGB")
        print(json.dumps({"lpips_alex": lpips_images(params, a, b)}))
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
