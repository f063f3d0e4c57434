"""The port's fidelity metrics against the JAX package's: PSNR, SSIM and
MS-SSIM to 1e-12 on seeded images (they are numpy copies), CLIP drift on
the tiny 2.1 pair within 1e-5, ``latent_rmse``; LPIPS on the same weights
(``weights.from_jax.lpips_from_jax``) within 1e-5 relative at 64² and 96²;
the weights file read and written in JAX's safetensors layout by the port's
own reader and writer; and the torch-checkpoint converter."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kandinsky2_tpu import eval as jeval
from kandinsky2_tpu import lpips as jlpips
from kandinsky2_tpu_torch import eval as teval
from kandinsky2_tpu_torch import lpips as tlpips
from kandinsky2_tpu_torch.weights.from_jax import lpips_from_jax

METRIC_TOL = 1e-12  # numpy copies: equal up to the last bits
LPIPS_TOL = 1e-5  # relative, fp32 convolutions in another order
jax_lpips = jax.jit(jlpips.lpips_distance)


def smooth_pair(shape, seed):
    """A smooth seeded image (uint8 values as float64) and a noisy copy."""
    rng = np.random.RandomState(seed)
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    base = 127 + 100 * np.sin(x / 9.0 + seed) * np.cos(y / 7.0)
    base = np.stack([base] * shape[2], -1) if len(shape) == 3 else base
    noisy = np.clip(base + rng.randn(*base.shape) * 20, 0, 255)
    return np.round(base), np.round(noisy)


@pytest.mark.parametrize("shape", [(64, 64, 3), (200, 180, 3), (40, 50), (11, 30, 3)])
def test_pixel_metrics_match_jax(shape):
    a, b = smooth_pair(shape, 1)
    for name in ("psnr", "ssim", "ms_ssim"):
        got = getattr(teval, name)(a, b)
        want = getattr(jeval, name)(a, b)
        assert abs(got - want) <= METRIC_TOL * max(1.0, abs(want)), (name, got, want)
    assert teval.psnr(a, a) == float("inf")
    assert teval.ssim(a, a) == pytest.approx(1.0, abs=1e-12)


def test_ms_ssim_refuses_tiny_images_like_jax():
    a, b = smooth_pair((10, 40, 3), 2)
    for mod in (teval, jeval):
        with pytest.raises(ValueError, match="11px"):
            mod.ms_ssim(a, b)


def test_latent_rmse_matches_jax():
    rng = np.random.RandomState(3)
    a, b = rng.randn(2, 8, 8, 4), rng.randn(2, 8, 8, 4)
    got = teval.latent_rmse(torch.from_numpy(a), b)
    assert got == pytest.approx(jeval.latent_rmse(a, b), rel=1e-6)


def test_clip_perceptual_distance_matches_jax():
    from PIL import Image

    from test_torch_common import shared_pair

    jp, tp, _ = shared_pair("2.1")
    rng = np.random.RandomState(4)
    a = Image.fromarray(rng.randint(0, 256, (40, 48, 3), np.uint8))
    b = Image.fromarray(rng.randint(0, 256, (40, 48, 3), np.uint8))
    got = teval.clip_perceptual_distance(tp, a, b)
    want = jeval.clip_perceptual_distance(jp, a, b)
    assert abs(got - want) <= 1e-5 and want > 1e-4
    assert abs(teval.clip_perceptual_distance(tp, a, a)) <= 1e-6


# --- LPIPS ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return jlpips.init_random_lpips(0)


@pytest.mark.parametrize("size", [64, 96])
def test_lpips_matches_jax(jax_params, size):
    rng = np.random.default_rng(size)
    a = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.5, a.shape), -1, 1).astype(np.float32)
    got = tlpips.lpips_distance(lpips_from_jax(jax_params), a, b).numpy()
    want = np.asarray(jax_lpips(jax_params, jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=LPIPS_TOL, atol=0)
    assert (want > 0).all()
    same = tlpips.lpips_distance(lpips_from_jax(jax_params), a, a).numpy()
    np.testing.assert_allclose(same, 0.0, atol=1e-8)


def test_lpips_images_matches_jax(jax_params):
    from PIL import Image

    rng = np.random.RandomState(5)
    a = Image.fromarray(rng.randint(0, 256, (64, 64, 3), np.uint8))
    b = Image.fromarray(rng.randint(0, 256, (64, 64, 3), np.uint8))
    got = tlpips.lpips_images(lpips_from_jax(jax_params), a, b)
    want = jlpips.lpips_images(jax_params, a, b)
    assert got == pytest.approx(want, rel=LPIPS_TOL)


def test_weights_files_cross_load(jax_params, tmp_path):
    """JAX's file loads into the port equal; the port's file is the same
    bytes as JAX's and loads equal through ``safetensors.numpy``."""
    from safetensors.numpy import load_file

    jax_file, port_file = tmp_path / "jax.safetensors", tmp_path / "port.safetensors"
    jlpips.save_lpips_weights(jax_params, str(jax_file))
    port = tlpips.load_lpips_weights(str(jax_file), device="cpu")
    want = lpips_from_jax(jax_params)
    assert set(port) == set(want)
    for k in want:
        assert port[k].dtype == torch.float32 and torch.equal(port[k], want[k]), k
    tlpips.save_lpips_weights(port, str(port_file))
    flat = load_file(str(port_file))
    for key, sub in jax_params.items():
        for leaf, arr in sub.items():
            got = flat[f"{key}.{leaf}"]
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, np.asarray(arr))
    assert port_file.read_bytes() == jax_file.read_bytes()
    drawn = tlpips.init_random_lpips(torch.Generator().manual_seed(1))
    tlpips.save_lpips_weights(drawn, str(port_file))
    again = tlpips.load_lpips_weights(str(port_file), device="cpu")
    assert all(torch.equal(again[k], drawn[k]) for k in drawn)
    del flat["lin4.weight"]
    from safetensors.numpy import save_file

    save_file(flat, str(port_file))
    with pytest.raises(KeyError, match="lin4"):
        tlpips.load_lpips_weights(str(port_file), device="cpu")


def torch_state_dicts(seed, lin_prefix="lin{}.model.1.weight"):
    """A torchvision-layout alexnet state dict and lpips lin heads."""
    rng = np.random.RandomState(seed)
    alex, in_ch = {}, 3
    for key, out_ch, k, _, _, _ in jlpips._CONVS:
        alex[f"{key}.weight"] = torch.from_numpy(
            rng.randn(out_ch, in_ch, k, k).astype(np.float32) * 0.05)
        alex[f"{key}.bias"] = torch.from_numpy(rng.randn(out_ch).astype(np.float32))
        in_ch = out_ch
    lin = {lin_prefix.format(i): torch.from_numpy(
        rng.uniform(0, 0.1, (1, ch, 1, 1)).astype(np.float32))
        for i, ch in enumerate(jlpips.CHANNELS)}
    return alex, lin


@pytest.mark.parametrize("prefix", ["lin{}.model.1.weight", "lins.{}.model.1.weight"])
def test_convert_state_dicts_matches_jax(prefix):
    alex, lin = torch_state_dicts(6, prefix)
    got = tlpips.convert_lpips_state_dicts(alex, lin)
    want = lpips_from_jax(jlpips.convert_lpips_state_dicts(alex, lin))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_convert_rejects_what_jax_rejects():
    alex, lin = torch_state_dicts(7)
    neg = dict(lin, **{"lin2.model.1.weight": -lin["lin2.model.1.weight"]})
    short = dict(lin, **{"lin1.model.1.weight": lin["lin1.model.1.weight"][:, :5]})
    bad_conv = dict(alex, **{"features.3.weight": alex["features.3.weight"][:, :, :3]})
    missing = {k: v for k, v in lin.items() if not k.startswith("lin4")}
    for a, l, err in [(alex, neg, ValueError), (alex, short, ValueError),
                      (bad_conv, lin, ValueError), (alex, missing, KeyError)]:
        for mod in (tlpips, jlpips):
            with pytest.raises(err):
                mod.convert_lpips_state_dicts(a, l)


def test_cli_converts_and_scores(tmp_path, capsys):
    """``--alex/--lin/--out`` writes the file JAX's converter writes (a
    full lpips checkpoint given for both), and ``--weights/--images``
    prints the distance JAX's LPIPS gives."""
    from PIL import Image

    alex, lin = torch_state_dicts(8)
    full = {f"net.slice{i}.{k.split('.', 1)[1]}": v
            for i, (k, v) in enumerate(alex.items())}
    full.update(lin)
    ckpt = tmp_path / "lpips_full.pth"
    torch.save(full, ckpt)
    out = tmp_path / "port.safetensors"
    assert tlpips.main(["--alex", str(ckpt), "--lin", str(ckpt), "--out", str(out)]) == 0
    jlpips.convert_torch_files(str(ckpt), str(ckpt), str(tmp_path / "jax.safetensors"))
    assert out.read_bytes() == (tmp_path / "jax.safetensors").read_bytes()
    rng = np.random.RandomState(9)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(rng.randint(0, 256, (64, 64, 3), np.uint8)).save(paths[-1])
    capsys.readouterr()
    assert tlpips.main(["--weights", str(out), "--images", *paths,
                        "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["lpips_alex"]
    want = jlpips.lpips_images(jlpips.load_lpips_weights(str(out)),
                               Image.open(paths[0]).convert("RGB"),
                               Image.open(paths[1]).convert("RGB"))
    assert got == pytest.approx(want, rel=LPIPS_TOL)
