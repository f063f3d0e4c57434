"""Hand-written Hopper kernels of the port and their plain versions.

Each kernel wrapper carries an integer ``launches`` attribute that it bumps
where it launches its kernel, and nowhere else.  (The submodules
``group_norm`` and ``flash_attention`` keep their names here; import the
functions from them.)
"""

from . import flash_attention as _flash
from . import group_norm as _group_norm
from .attention import added_kv_attention, qkv_attention

KERNEL_WRAPPERS = {
    "group_norm_stats": _group_norm.group_norm_stats,
    "group_norm_apply": _group_norm.group_norm_apply,
    "flash_attention_fwd": _flash.flash_attention_fwd,
    "flash_attention_bwd_dkv": _flash.flash_attention_bwd_dkv,
    "flash_attention_bwd_dq": _flash.flash_attention_bwd_dq,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
