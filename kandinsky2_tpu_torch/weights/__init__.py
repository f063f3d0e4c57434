"""Checkpoint loading (the published checkpoints from a local cache:
``hub``, ``convert``, ``load_kandinsky``, ``load_kandinsky22``,
``configs22``) and the Flax -> PyTorch weight bridge (``from_jax``)."""

from .from_jax import jax_to_state_dict, load_jax_params, plan, torch_key_for
