"""The PyTorch port must not load JAX, flax, optax or the JAX package:
importing every submodule of ``kandinsky2_tpu_torch`` in a fresh
interpreter leaves none of them in ``sys.modules``, and the scripts that
run on the card import none of them.  Its kernels are CUDA C++, so no
module of it imports Triton either, at any depth of its code.  The card's
machine has none of cv2, PyYAML, safetensors, transformers, huggingface_hub,
lpips and torchvision: no module imports cv2, safetensors, transformers,
huggingface_hub, lpips or torchvision, and PyYAML is imported only inside a
CLI's ``main``.  The port downloads nothing: no module imports
``urllib.request``."""

import ast
import os
import subprocess
import sys

import pytest

_CHECK = """
import importlib, pkgutil, sys
import kandinsky2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "kandinsky2_tpu",
                                    "triton", "cv2", "yaml", "safetensors", "lpips",
                                    "torchvision", "transformers", "huggingface_hub"))
print(len(names), bad, " ".join(names))
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 40
    # the host side of 2.1 inference, the 2.2 and 2.0 slices and training
    # are covered too, and the examples
    for name in ("tokenizers.clip_bpe", "tokenizers.textfix", "host_ops", "utils",
                 "diffusion.samplers", "pipelines.kandinsky2_1", "diffusion.paired",
                 "models.unet22", "models.prior22", "weights.configs22",
                 "pipelines.kandinsky2_2", "depth", "models.t5",
                 "pipelines.kandinsky2_0", "pipelines.base", "models.lora",
                 "train.precision", "train.train_lora", "train.distill",
                 "train.train_prior", "train.train_prior_cli", "train.masks",
                 "train.train_2_1_unclip", "observability", "eval", "lpips",
                 "weights.realistic", "weights.safetensors_file", "serving",
                 "serving_http", "validate", "weights.convert", "weights.hub",
                 "weights.load_kandinsky", "weights.load_kandinsky22", "models.dpt",
                 "examples.common", "examples.train_lora_22", "examples.run_all",
                 "parallel.mesh", "parallel.collectives", "parallel.spatial",
                 "parallel.launch", "examples.highres_sp_decode", "examples.train_sp",
                 "parallel.tensor_parallel", "parallel.fsdp"):
        assert f"kandinsky2_tpu_torch.{name}" in proc.stdout.split(), name


def test_entry_points_default_to_the_card():
    """The rank launcher and the entry points that spawn ranks run on the
    card unless the caller asks for the CPU: a rank fails where there is
    no card rather than falling back.  The row-sharded entry points
    (``sp_mesh=`` on every image entry point of the three pipelines) run
    where their pipeline is, the card unless built with ``device="cpu"``,
    and the sharded trainers (``make_sp_lora_train_fn``,
    ``make_spdp_train_fn``) where their UNet is: neither takes a device of
    its own.  Tensor parallelism (``make_mesh``, ``shard_params``,
    ``shard_pipeline`` and every pipeline's ``shard``) runs where the
    pipeline is too: none takes a device.  Nor does FSDP
    (``make_fsdp_train_fn``, ``train_unclip(fsdp=)``, the placement and
    ``parallel.fsdp``): it runs where the UNet is, and the CLI that spawns
    its ranks (``run``, ``run_parallel``) defaults to the card."""
    import inspect

    from kandinsky2_tpu_torch.parallel import fsdp, launch, mesh
    from kandinsky2_tpu_torch.pipelines import Kandinsky2, Kandinsky2_1, Kandinsky2_2
    from kandinsky2_tpu_torch.train import train_2_1_unclip, train_lora, train_unclip

    for fn in (launch.RankPool, launch.run_ranks, train_2_1_unclip.run,
               train_2_1_unclip.run_parallel, Kandinsky2, Kandinsky2_1, Kandinsky2_2):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    sharded = {
        Kandinsky2_2: ("generate_text2img", "generate_img2img", "generate_text2img_hires",
                       "mix_images", "generate_inpainting", "generate_controlnet",
                       "decode_latents", "_decode_loop"),
        Kandinsky2: ("generate_img", "generate_text2img", "generate_img2img",
                     "generate_inpainting", "decode_latents"),
        Kandinsky2_1: ("generate_img", "generate_text2img", "generate_text2img_hires",
                       "mix_images", "generate_img2img", "generate_inpainting",
                       "decode_latents"),
    }
    for cls, names in sharded.items():
        for name in names:
            params = inspect.signature(getattr(cls, name)).parameters
            assert params["sp_mesh"].default is None and "device" not in params, name
    for fn in (train_lora.make_sp_lora_train_fn, train_lora.make_lora_train_step,
               train_unclip.make_spdp_train_fn, mesh.make_mesh, mesh.shard_params,
               mesh.shard_pipeline, Kandinsky2.shard, Kandinsky2_1.shard,
               Kandinsky2_2.shard, train_unclip.make_fsdp_train_fn,
               train_unclip.train_unclip, mesh.fsdp_state_shardings, fsdp.shard_state_,
               fsdp.gather_state, fsdp.place_state):
        assert "device" not in inspect.signature(fn).parameters, fn


@pytest.mark.parametrize("script", ["chip_smoke.py", "kernel_ab.py"])
def test_scripts_import_no_jax(script):
    """The card's scripts import neither JAX, the JAX package nor Triton, at
    any depth of their code."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = _imported(os.path.join(root, script))
    assert "kandinsky2_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "optax", "kandinsky2_tpu", "triton",
                        "cv2", "yaml", "safetensors", "lpips", "torchvision",
                        "transformers", "huggingface_hub"}, names


def _imported(path, full=False):
    """The top-level names (with ``full``, the whole dotted names) of every
    import statement in a source file, function bodies included."""
    with open(path) as f:
        tree = ast.parse(f.read())
    top = (lambda n: n) if full else (lambda n: n.split(".")[0])
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(top(node.module))
            if full:
                names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def test_port_modules_import_no_triton():
    """No module of the port imports Triton, JAX or a package the card's
    machine lacks, not even inside a function, where importing the module
    would not show it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "kandinsky2_tpu_torch")
    paths = [os.path.join(d, f) for d, _, files in os.walk(pkg) for f in files
             if f.endswith(".py")]
    assert len(paths) >= 36
    for path in paths:
        names = _imported(path)
        assert not names & {"triton", "jax", "jaxlib", "flax", "optax",
                            "kandinsky2_tpu", "cv2", "safetensors", "lpips",
                            "torchvision", "transformers", "huggingface_hub"}, (path, names)
        assert "urllib.request" not in _imported(path, full=True), path


def test_yaml_only_inside_a_cli_main():
    """PyYAML is imported nowhere in the port but inside a function named
    ``main``, and the two training CLIs do import it there."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "kandinsky2_tpu_torch")
    where = {}
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                for fn in _yaml_imports(path):
                    where.setdefault(os.path.relpath(path, pkg), []).append(fn)
    assert where == {os.path.join("train", "train_2_1_unclip.py"): ["main"],
                     os.path.join("train", "train_prior_cli.py"): ["main"]}, where


def _yaml_imports(path):
    """The name of the function around each import of ``yaml`` in a source
    file (None at module level)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    found = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            names = ([a.name for a in child.names] if isinstance(child, ast.Import)
                     else [child.module or ""] if isinstance(child, ast.ImportFrom)
                     else [])
            if any(n.split(".")[0] == "yaml" for n in names):
                found.append(fn)
            visit(child, fn)

    visit(tree, None)
    return found
