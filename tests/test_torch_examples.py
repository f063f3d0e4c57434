"""The port's example scripts (``kandinsky2_tpu_torch/examples/``), each run
with ``--small --device cpu`` through ``runpy`` as ``__main__`` in this
process (``examples.run_all``): finite images of the size its JAX
counterpart in ``examples/`` makes, or the steps it trains.  Their flags
and defaults are the JAX scripts', and importing one runs nothing."""

import ast
import os
import subprocess
import sys

import pytest

from kandinsky2_tpu_torch.examples import run_all

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "kandinsky2_tpu_torch", "examples")
JAX_DIR = os.path.join(ROOT, "examples")


def test_the_eighteen_single_card_examples_are_ported():
    """Every JAX example is ported: the eighteen single-card ones and
    ``train_sp`` (two CPU ranks with ``--small``) are in ``run_all``;
    ``highres_sp_decode`` runs on its own ranks below."""
    jax_scripts = {f[:-3] for f in os.listdir(JAX_DIR)
                   if f.endswith(".py") and f != "common.py"}
    assert set(run_all.EXAMPLES) == jax_scripts - {"highres_sp_decode"}
    assert len(run_all.EXAMPLES) == 19 and run_all.OWN_FLAGS == {"train_sp"}
    for name in [*run_all.EXAMPLES, "highres_sp_decode"]:
        assert os.path.exists(os.path.join(PORT_DIR, f"{name}.py")), name


@pytest.mark.parametrize("name", list(run_all.EXAMPLES))
def test_example_runs_small_on_the_cpu(name, tmp_path):
    result = run_all.run_example(name, "cpu", str(tmp_path))
    print(run_all.check_example(result))
    with open(os.path.join(JAX_DIR, f"{name}.py")) as f:
        saves = 'print("saved"' in f.read()
    size = run_all.EXAMPLES[name][1]
    assert (f"saved {result['out']} ({size}, {size})" in result["lines"]) == saves


def _argparser_extras(path):
    """The keyword flags of the ``argparser(...)`` call in a script."""
    with open(path) as f:
        tree = ast.parse(f.read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "argparser"]
    assert len(calls) == 1, path
    return {kw.arg: ast.literal_eval(kw.value) for kw in calls[0].keywords}


@pytest.mark.parametrize("name", [n for n in run_all.EXAMPLES
                                  if n not in run_all.OWN_FLAGS])
def test_flags_and_defaults_are_the_jax_scripts(name):
    assert _argparser_extras(os.path.join(PORT_DIR, f"{name}.py")) == \
        _argparser_extras(os.path.join(JAX_DIR, f"{name}.py"))


def test_common_flags_are_the_jax_scripts_plus_device_and_cache():
    from kandinsky2_tpu_torch.examples.common import argparser

    ns = vars(argparser().parse_args([]))
    assert ns == {"small": False, "prompt": "red cat, 4k photo", "out": "out.png",
                  "steps": None, "res": None, "device": "cuda",
                  "cache_dir": "/tmp/kandinsky2"}


def test_no_example_does_work_at_import():
    """Each module's top level holds only imports, definitions, constants and
    the ``if __name__ == "__main__": main()`` guard; importing them all in
    a fresh interpreter prints nothing."""
    names = sorted(f[:-3] for f in os.listdir(PORT_DIR) if f.endswith(".py"))
    for name in names:
        with open(os.path.join(PORT_DIR, f"{name}.py")) as f:
            body = ast.parse(f.read()).body
        for node in body:
            if isinstance(node, ast.If):
                assert ast.unparse(node.test) == "__name__ == '__main__'", name
                assert [ast.unparse(s) for s in node.body] == ["main()"], name
            elif isinstance(node, ast.Expr):
                assert isinstance(node.value, ast.Constant), (name, ast.unparse(node))
            elif isinstance(node, ast.Assign):
                ast.literal_eval(node.value)
            else:
                assert isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef)), \
                    (name, ast.unparse(node))
    code = ("import importlib\n" + "".join(
        f"importlib.import_module('kandinsky2_tpu_torch.examples.{n}')\n" for n in names))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0 and proc.stdout == "", proc.stdout + proc.stderr


def test_highres_sp_decode_small_on_two_cpu_ranks(capsys):
    """The spatially parallel decode with ``--small`` over 2 gloo ranks on
    the CPU: a finite 64² image, every rank's rows gathered."""
    from kandinsky2_tpu_torch.examples import highres_sp_decode

    highres_sp_decode.main(["--small", "--world", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "2 ranks on cpu, image rows sharded 2-way"
    assert lines[-1].startswith("decoded 64²x3 in ") and lines[-1].endswith("finite=True")


def _add_argument_flags(path):
    """{flag: its keywords but help} of every ``add_argument`` call."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return {ast.literal_eval(n.args[0]): {kw.arg: ast.unparse(kw.value)
                                          for kw in n.keywords if kw.arg != "help"}
            for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", None) == "add_argument"}


def test_train_sp_flags_and_lines_are_the_jax_scripts():
    """``--data``, ``--sp``, ``--res``, ``--steps`` and ``--full`` as the JAX
    script's, defaults too; ``--device`` (the card by default) in place of
    its ``--cpu N``, and ``--small`` for ``run_all``.  The printed lines
    are the JAX script's formats."""
    jax_flags = _add_argument_flags(os.path.join(JAX_DIR, "train_sp.py"))
    port_flags = _add_argument_flags(os.path.join(PORT_DIR, "train_sp.py"))
    assert {k: v for k, v in port_flags.items() if k not in ("--device", "--small")} \
        == {k: v for k, v in jax_flags.items() if k != "--cpu"}
    assert port_flags["--device"] == {"default": "'cuda'"}
    with open(os.path.join(JAX_DIR, "train_sp.py")) as f:
        jax_src = f.read()
    with open(os.path.join(PORT_DIR, "train_sp.py")) as f:
        port_src = f.read()
    for fmt in ("params, mesh ", "(data x sp), ", "rows sharded ", '"SP training OK"',
                "s)\""):
        assert fmt in jax_src and fmt in port_src, fmt


def test_highres_sp_decode_flags_are_the_jax_scripts():
    """``--res`` and ``--full`` as the JAX script's (its defaults too);
    ``--world`` (ranks) in place of its ``--cpu N`` (virtual devices), and
    the port's ``--device`` and ``--small``."""
    def flags(path):
        with open(path) as f:
            tree = ast.parse(f.read())
        return {ast.literal_eval(n.args[0]): {kw.arg: ast.unparse(kw.value)
                                              for kw in n.keywords if kw.arg != "help"}
                for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "add_argument"}

    jax_flags = flags(os.path.join(JAX_DIR, "highres_sp_decode.py"))
    port_flags = flags(os.path.join(PORT_DIR, "highres_sp_decode.py"))
    assert {k: v for k, v in port_flags.items()
            if k not in ("--world", "--device", "--small")} == \
        {k: v for k, v in jax_flags.items() if k != "--cpu"}
    assert port_flags["--world"]["type"] == jax_flags["--cpu"]["type"] == "int"
