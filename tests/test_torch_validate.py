"""The port's validation harness against the JAX package's: with a
``pipe_builder`` the whole offline ladder runs (bootstrap, then PSNR inf,
SSIM 1, the CLIP drift 0 and the native LPIPS 0 on the seeded repeat);
without one it stops at ``fetch`` for 2.0, 2.1 and 2.2, with the stage
names and report keys of JAX's offline run; ``run_metrics`` scores the same
pair as JAX's.  Also the port's observability helpers against JAX's."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from kandinsky2_tpu import observability as jobs
from kandinsky2_tpu import validate as jvalidate
from kandinsky2_tpu_torch import observability as tobs
from kandinsky2_tpu_torch import validate as tvalidate


def small_builder(version):
    """A ``pipe_builder`` of the port's small ``version`` pipeline in fp32
    on the CPU."""
    def build():
        from kandinsky2_tpu_torch.configs import small_config, small_overrides22
        from kandinsky2_tpu_torch.pipelines import Kandinsky2_1, Kandinsky2_2
        from kandinsky2_tpu_torch.utils import stub_tokenizer22, stub_tokenizers

        kw = dict(dtype=torch.float32, device="cpu")
        if version == "2.2":
            pipe = Kandinsky2_2(tokenizer=stub_tokenizer22(64),
                                overrides=small_overrides22(32), **kw)
        else:
            tok1, tok2 = stub_tokenizers()
            pipe = Kandinsky2_1(config=small_config(), tokenizer1=tok1,
                                tokenizer2=tok2, **kw)
        pipe.init_random_params(torch.Generator().manual_seed(2))
        return pipe

    return build


def test_full_ladder_with_a_builder(tmp_path):
    """Bootstrap, then the seeded repeat against it: PSNR inf, SSIM and
    MS-SSIM 1, CLIP drift 0, and LPIPS 0 from a weights file written by the
    port (``lpips_backend`` "native-torch")."""
    from kandinsky2_tpu_torch.lpips import init_random_lpips, save_lpips_weights

    out1, out2 = str(tmp_path / "out1"), str(tmp_path / "out2")
    kw = dict(h=64, w=64, num_steps=4)
    rep1 = tvalidate.validate(pipe_builder=small_builder("2.1"), out_dir=out1, **kw)
    assert rep1["ok"], rep1
    assert list(rep1["stages"]) == ["build", "generate", "metrics"]
    assert all(s["status"] == "ok" for s in rep1["stages"].values())
    assert os.path.exists(rep1["outputs"][0])
    assert "bootstrap" in rep1["metrics"]["note"]
    weights = str(tmp_path / "lpips.safetensors")
    save_lpips_weights(init_random_lpips(torch.Generator().manual_seed(0)), weights)
    rep2 = tvalidate.validate(pipe_builder=small_builder("2.1"), out_dir=out2,
                              reference_dir=out1, lpips_weights=weights, **kw)
    assert rep2["ok"], rep2
    m = rep2["metrics"][0]
    assert m["psnr_db"] == float("inf") and m["ssim"] == 1.0 and m["ms_ssim"] == 1.0
    assert m["lpips_backend"] == "native-torch"
    assert m["lpips_alex"] == 0.0 and m["lpips_gate_0.02"] is True
    assert abs(m["clip_cosine_drift"]) <= 1e-6
    json.dumps(rep2, default=str)
    assert np.asarray(Image.open(rep2["outputs"][0])).std() > 0


def test_ladder_22_and_unevaluated_lpips(tmp_path, monkeypatch):
    """2.2 through ``run_generation_22`` (no CLIP drift, as in JAX); with
    no LPIPS weights and no ``lpips`` package the gate says so."""
    monkeypatch.setattr(tvalidate, "lpips_available", lambda: False)
    kw = dict(version="2.2", h=64, w=64, num_steps=3)
    out1 = str(tmp_path / "a")
    assert tvalidate.validate(pipe_builder=small_builder("2.2"), out_dir=out1, **kw)["ok"]
    rep = tvalidate.validate(pipe_builder=small_builder("2.2"), out_dir=str(tmp_path / "b"),
                             reference_dir=out1, **kw)
    assert rep["ok"], rep
    m = rep["metrics"][0]
    assert m["psnr_db"] == float("inf") and "clip_cosine_drift" not in m
    assert m["lpips_alex"] is None and "not evaluated" in m["lpips_gate_0.02"]


@pytest.mark.parametrize("version", ["2.0", "2.1", "2.2"])
def test_stops_at_fetch_like_jax(version, monkeypatch, tmp_path):
    """No pipe_builder and no cached checkpoints: the fetch stage fails naming
    the missing file, with the stage names and report keys of JAX's run
    stopped at fetch."""
    import kandinsky2_tpu.weights.hub as hub

    def no_network(*a, **k):
        raise OSError("network unavailable")

    monkeypatch.setattr(hub, f"fetch_{version.replace('.', '_')}", no_network)
    want = jvalidate.validate(version=version, h=64, w=64, num_steps=4)
    got = tvalidate.validate(version=version, cache_dir=str(tmp_path), h=64, w=64,
                             num_steps=4)
    assert got["stopped_at"] == want["stopped_at"] == "fetch"
    assert not got["ok"] and not want["ok"]
    assert set(got) == set(want)
    assert {k: got[k] for k in got if k != "stages"} == {
        k: want[k] for k in want if k != "stages"}
    assert list(got["stages"]) == list(want["stages"]) == ["fetch"]
    stage = got["stages"]["fetch"]
    assert set(stage) == set(want["stages"]["fetch"])
    assert stage["status"] == "failed"
    assert stage["error"].startswith("FileNotFoundError") and str(tmp_path) in stage["error"]
    assert "not in the cache" in stage["error"]
    with pytest.raises(ValueError):
        tvalidate.validate(version="3.0")


def test_cli_stops_at_fetch(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert tvalidate.main(["--version", "2.1", "--cache-dir", str(tmp_path),
                           "--out", str(out)]) == 1
    rep = json.loads(out.read_text())
    assert rep["stopped_at"] == "fetch" and rep["version"] == "2.1"


def test_run_metrics_scores_like_jax(tmp_path):
    """A perturbed reference: the same PSNR, SSIM and MS-SSIM as JAX's
    ``run_metrics``, below its parity thresholds."""
    rng = np.random.RandomState(0)
    g = np.linspace(0, 255, 64)
    base = np.stack([np.add.outer(g, g) / 2] * 3, axis=-1).astype(np.uint8)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    noisy = np.clip(base.astype(np.int32) + rng.randint(-40, 40, base.shape), 0, 255)
    Image.fromarray(noisy.astype(np.uint8)).save(ref_dir / "generated_0.png")
    reports = []
    for mod in (tvalidate, jvalidate):
        report = {}
        mod.run_metrics(report, [Image.fromarray(base)], str(ref_dir),
                        str(tmp_path / "out"))
        reports.append(report["metrics"][0])
    got, want = reports
    for k in ("psnr_db", "ssim", "ms_ssim", "lpips_alex"):
        assert got[k] == want[k], k
    assert got["psnr_db"] < 30 and got["ssim"] < 0.9


def test_lpips_package_path_is_optional(monkeypatch):
    """The optional ``lpips`` package is looked for, never imported with
    the module; without it ``compute_lpips`` answers None."""
    import importlib.util

    assert tvalidate.lpips_available() == (importlib.util.find_spec("lpips") is not None)
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    assert tvalidate.lpips_available() is False
    img = Image.new("RGB", (16, 16))
    assert tvalidate.compute_lpips(img, img) is None


# --- observability -------------------------------------------------------------


def test_stage_report_matches_jax():
    rep_t, rep_j = tobs.StageReport(), jobs.StageReport()
    with rep_t.stage("a", result_to_sync=torch.ones(4)):
        torch.ones(8) * 2
    with tobs.stage_timer(rep_t, "b"):
        pass
    with tobs.stage_timer(None, "c"):
        pass
    assert list(rep_t.times) == ["a", "b"] and rep_t.times["a"] >= 0
    rep_t.times = {"prior": 0.25, "decoder": 1.5, "codec": 0.125}
    rep_j.times = dict(rep_t.times)
    assert str(rep_t) == str(rep_j)


def test_sync_guard_and_progress(capsys):
    x = torch.tensor([1.0, float("nan")])
    assert tobs.sync(x) is x
    nested = {"a": [None, (x,)]}
    assert tobs.sync(nested) is nested and tobs.sync(3) == 3
    assert tobs.guard_finite(x, "x") is x
    assert capsys.readouterr().out == ""
    tobs.GUARD_NANS = True
    try:
        assert tobs.guard_finite(x, "latents") is x
        assert tobs.guard_finite(torch.ones(2), "ok") is not None
    finally:
        tobs.GUARD_NANS = False
    assert capsys.readouterr().out == "!! non-finite values in latents\n"
    for p in range(5):
        tobs.progress(p, 5, label="t", every=2)
    assert capsys.readouterr().out == "\rt 1/5\rt 3/5\rt 5/5"


def test_trace_writes_a_profile(tmp_path):
    with tobs.trace(str(tmp_path / "trace")) as d:
        torch.ones(16) @ torch.ones(16)
    files = [f for _, _, fs in os.walk(d) for f in fs]
    assert any(f.endswith(".json") for f in files), files
