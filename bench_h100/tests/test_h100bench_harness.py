"""The harness on the CPU: BENCHMARK.json against the contract, files found
by name, the result line, no JAX, no fallback to the CPU, and the check
failing where the timed path is broken or the control stands in its
place.  The cells run at the tiny widths of ``data/`` through
``run.run_cell``, which skips only the look for a card."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from bench_h100 import control, kinds, run
from bench_h100.kinds import text2img22 as t2i
from bench_h100.kinds import train_unclip21 as train

from .common import tiny_spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = run.load_json(run.CHECKOUT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**33 + 5


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) for w in BENCH["command"])
    assert os.path.getsize(os.path.join(run.CHECKOUT, "BENCHMARK.json")) <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"bench_h100/configs/{c['name']}.json"
        assert run.load_json(run.CHECKOUT, c["file"])["source"] == c["source"]
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        own = run.load_json(run.HERE, "workloads", f"{w['name']}.json")
        assert {k: own[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert os.path.exists(run.reader_path(m["name"]))
    for cell in CELLS:
        reports, per_layer = run.cell_metrics(BENCH, cell)
        names = {m["name"] for m in reports}
        assert "setup_s" in names and len(names) >= 2 and per_layer
        assert all(m["moves"] in names for m in per_layer)


def test_files_dropped_into_the_folders_are_found(tmp_path, monkeypatch):
    for sub in ("configs", "traffic", "workloads", "metrics", "kinds"):
        shutil.copytree(os.path.join(run.HERE, sub), tmp_path / sub)
    cfg = run.load_json(run.HERE, "configs", "kandinsky22.json")
    (tmp_path / "configs" / "newmodel.json").write_text(json.dumps(dict(cfg, source="x")))
    tr = dict(run.load_json(run.HERE, "traffic", "t2i-768-b4.json"), batch=2)
    (tmp_path / "traffic" / "t2i-768-b2.json").write_text(json.dumps(tr))
    (tmp_path / "workloads" / "new-cell.json").write_text(json.dumps(
        {"config": "newmodel", "traffic": "t2i-768-b2", "chips": 1, "why": "w",
         "limits": {"image_gap": 0.1}}))
    (tmp_path / "metrics" / "new_metric.t2i.py").write_text("def read(w):\n    return 7.0\n")
    (tmp_path / "metrics" / "family.py").write_text("def read(w):\n    return 8.0\n")
    (tmp_path / "kinds" / "newkind.py").write_text(
        "class Cell:\n    def __init__(self, cfg, traffic, seed, device):\n"
        "        self.args = (cfg, traffic, seed, device)\n")
    monkeypatch.setattr(run, "HERE", str(tmp_path))
    monkeypatch.setattr(kinds, "__path__", [str(tmp_path / "kinds")] + list(kinds.__path__))
    spec = run.cell_spec("new-cell")
    assert spec["cfg"]["source"] == "x" and spec["tr"]["batch"] == 2
    assert run.load_reader("new_metric.t2i").read(None) == 7.0
    assert run.load_reader("family.t2i").read(None) == run.load_reader("family.x").read(None) == 8
    assert run.reader_path("mfu.train") == run.reader_path("mfu.t2i") == str(
        tmp_path / "metrics" / "mfu.py")
    assert isinstance(run.make_cell(spec, 1, "cpu"), t2i.Cell)
    new = run.make_cell(dict(spec, tr=dict(spec["tr"], kind="newkind")), 5, "cpu")
    assert new.args[2:] == (5, "cpu") and new.args[1]["kind"] == "newkind"
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "new_metric.t2i", "moves": "images_per_s", "workloads": ["new-cell"]},
        {"name": "every_cell", "moves": "setup_s"}])
    e2e, per_layer = run.cell_metrics(bench, "new-cell")
    assert [m["name"] for m in e2e] == ["setup_s"]
    assert [m["name"] for m in per_layer] == ["new_metric.t2i", "every_cell"]


@pytest.fixture(scope="module")
def t2i_runs():
    spec = tiny_spec("t2i22-768-b4")
    return [run.run_cell(spec, SEED, 0.2, trace, "cpu") for trace in (False, True)]


def test_result_line(t2i_runs):
    plain, traced = t2i_runs
    assert list(plain) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device",
                            "breakdown", "check"]
    assert plain["correct"] is True and plain["attempted"] >= 1 and plain["failed"] == 0
    assert set(plain["metrics"]) == {"images_per_s", "setup_s"}
    for m in plain["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(traced["device"]) >= {"platform", "kind", "count", "memory_peak_bytes",
                                     "busy_s", "window_s"}
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(traced["metrics"]) <= {m["name"] for m in BENCH["per_layer"]}
    assert set(plain["check"]) == {"image_gap"}
    assert set(plain["check"]["image_gap"]) == {"value", "limit"}
    json.dumps(traced)


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "kandinsky2_tpu_torch_x", sys)
    assert "kandinsky2_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "kandinsky2_tpu.sub", sys)
    assert "kandinsky2_tpu" in run.forbidden_modules()


def _top_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax_and_the_reference_nothing_of_the_program():
    for d, _, files in os.walk(run.HERE):
        if os.path.basename(d) == "tests":
            continue
        for f in (f for f in files if f.endswith(".py")):
            names = _top_imports(os.path.join(d, f))
            assert not names & {"jax", "jaxlib", "flax", "kandinsky2_tpu"}, (f, names)
            if os.path.basename(d) == "reference":
                assert "kandinsky2_tpu_torch" not in names and "bench_h100" not in names, f


def _python(code: str, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=run.CHECKOUT, capture_output=True,
                          text=True, timeout=600, env=dict(os.environ, **env))


def test_a_run_imports_no_jax():
    r = _python(
        "import json, sys\n"
        "from bench_h100 import run\n"
        "from bench_h100.tests.common import tiny_spec\n"
        "for cell in ('t2i22-768-b4', 'train21-768-b32'):\n"
        "    run.run_cell(tiny_spec(cell), 3, 0.1, False, 'cpu')\n"
        "print(json.dumps(run.forbidden_modules()))\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0].startswith('kandinsky'))[:3]))\n")
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []
    assert json.loads(lines[-1])[0].startswith("kandinsky2_tpu_torch")


def test_a_run_without_a_card_fails_and_prints_no_result():
    r = subprocess.run([sys.executable, "-m", "bench_h100.run", "--workload", CELLS[0],
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=run.CHECKOUT, capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout.strip() == ""


def _broken(monkeypatch, cls, wrap, window_only=False):
    """Break the cell's timed path from its first step on (``window_only``:
    from the window's first step on): ``wrap`` gets the cell once the
    program is built and changes what it runs."""
    train_cell = cls is train.Cell
    orig = cls._first_steps if train_cell else cls.setup

    def patched(self):
        if train_cell and not window_only:
            wrap(self)
            return orig(self)
        orig(self)
        wrap(self)

    monkeypatch.setattr(cls, "_first_steps" if train_cell else "setup", patched)


def test_an_altered_image_is_not_correct(monkeypatch):
    def wrap(cell):
        gen = cell._generate

        def altered(call, steps=None):
            out = gen(call, steps)
            out[0, : out.shape[1] // 4] *= -1.0
            return out

        cell._generate = altered

    _broken(monkeypatch, t2i.Cell, wrap)
    assert run.run_cell(tiny_spec("t2i22-768-b4"), SEED, 0.1, False, "cpu")["correct"] is False


def _unchanged(cell):
    step = cell.train_step

    def unchanged(state, batch, **kw):
        keep = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        ema = {n: e.clone() for n, e in state.ema_params.items()}
        out = step(state, batch, **kw)
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(keep[n])
            for n, e in state.ema_params.items():
                e.copy_(ema[n])
        return out

    cell.train_step = unchanged


@pytest.mark.parametrize("window_only", [False, True])
def test_a_train_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch, window_only):
    """From the first step, or only in the window once the checked steps
    of set-up have run soundly."""
    _broken(monkeypatch, train.Cell, _unchanged, window_only)
    r = run.run_cell(tiny_spec("train21-768-b32"), SEED, 0.1, False, "cpu")
    assert r["correct"] is False and r["check"]["window_change_gap"]["value"] > 0.99
    assert (r["check"]["change_gap"]["value"] > 0.99) is not window_only


def test_a_train_step_on_half_the_batch_is_not_correct(monkeypatch):
    def wrap(cell):
        step, B = cell.train_step, cell.traffic["batch"]
        cell.train_step = lambda state, batch, **kw: step(state, batch, rows=slice(0, B // 2),
                                                          **kw)

    _broken(monkeypatch, train.Cell, wrap)
    assert run.run_cell(tiny_spec("train21-768-b32"), SEED, 0.1, False, "cpu")["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [11, 2**32 + 3])
def test_the_control_is_not_correct(cell, seed):
    """The reference with float8 products in the program's place fails the
    cell's limits (the same check at the tiny widths)."""
    spec = tiny_spec(cell)
    readings = control.readings(spec, seed, "cpu")
    assert any(v > spec["limits"][k] for k, v in readings.items()), readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cells_run_traced_on_the_card(cell):
    """The card's path end to end at the tiny widths: the device ops are
    traced and the check runs (its limits are the full widths', so the
    tiny reading is not judged here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = run.run_cell(tiny_spec(cell), SEED, 1.0, True, "cuda")
    assert r["device"]["busy_s"] > 0 and r["breakdown"]["device_ops"]
    assert set(r["check"]) == set(tiny_spec(cell)["limits"])
