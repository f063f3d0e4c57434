"""The port's copy of the 2.2 configuration (``kandinsky2_tpu_torch/weights/
configs22.py`` and its ``fixtures22/``) against the JAX package's: the
vendored config files byte-identical, each task's overrides equal (the
vision tower's activation by name), and read from the port's own copy."""

import os

import pytest

from kandinsky2_tpu.weights import configs22 as jcfg
from kandinsky2_tpu_torch.weights import configs22 as tcfg

JAX_DIR = os.path.dirname(jcfg.__file__)
PORT_DIR = os.path.dirname(tcfg.__file__)


def test_fixtures_are_byte_identical():
    names = sorted(os.listdir(os.path.join(JAX_DIR, "fixtures22")))
    assert len(names) == 7
    assert sorted(os.listdir(os.path.join(PORT_DIR, "fixtures22"))) == names
    for name in names:
        with open(os.path.join(JAX_DIR, "fixtures22", name), "rb") as a, \
                open(os.path.join(PORT_DIR, "fixtures22", name), "rb") as b:
            assert a.read() == b.read(), name


def _comparable(ov):
    out = {k: dict(v) for k, v in ov.items()}
    act = out["image_encoder"].pop("act")
    return out, act.__name__


@pytest.mark.parametrize("task", ["text2img", "img2img", "inpainting", "controlnet"])
def test_pipeline_overrides_equal_jax(task):
    want, want_act = _comparable(jcfg.pipeline_overrides(None, None, task))
    got, got_act = _comparable(tcfg.pipeline_overrides(task_type=task))
    assert got == want
    assert got_act == want_act == "exact_gelu"
    assert got["unet"]["in_channels"] == {"inpainting": 9, "controlnet": 8}.get(task, 4)


@pytest.mark.parametrize("name", ["decoder__unet", "decoder-inpaint__unet",
                                  "controlnet__unet", "decoder__movq",
                                  "prior__prior", "prior__text_encoder",
                                  "prior__image_encoder"])
def test_fixtures_read_from_the_port(name):
    """The port reads its own copy of each vendored config, never the JAX
    package's directory, and it holds what the JAX loader reads there."""
    assert os.path.commonpath([tcfg.FIXTURES, PORT_DIR]) == PORT_DIR
    assert tcfg.load_fixture(name) == jcfg.load_model_config(None, "x", name)
