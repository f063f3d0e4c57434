"""Flax -> PyTorch weight bridge."""

from .from_jax import jax_to_state_dict, load_jax_params, plan, torch_key_for


def checkpoint_loaders_missing(version: str) -> NotImplementedError:
    """The error of an entry point that needs the published Kandinsky
    ``version`` checkpoints, which the port cannot load yet."""
    return NotImplementedError(
        f"the port has no loader of the published Kandinsky {version} "
        "checkpoints yet (the JAX package's weights/hub.py, "
        "weights/load_kandinsky.py and weights/load_kandinsky22.py wait for "
        "their files: ROADMAP Queue 1, item 6c); build the pipeline yourself "
        "(random weights: init_random_params) and pass it in")
