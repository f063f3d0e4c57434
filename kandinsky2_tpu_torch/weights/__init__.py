"""Flax -> PyTorch weight bridge."""

from .from_jax import jax_to_state_dict, load_jax_params, plan, torch_key_for
