"""Spatial (row) and data parallelism over ``torch.distributed``, the
counterpart of ``kandinsky2_tpu/parallel/`` (its spatial half and the
mesh's axis names): ``mesh`` (the one-axis mesh of the ranks, or the
``(data, sp)`` mesh of sharded training), ``collectives`` (ppermute, psum,
pmean, all_gather, each differentiable through its transpose, and the
bucketed gradient all-reduce ``pmean_grads``; gloo staging of CUDA
tensors), ``spatial`` (halo convolutions, sharded attention with the
ring's K5/K4 backward, ``spatial_decode`` / ``spatial_encode``) and
``launch`` (one process per shard, with a deadline).
"""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, MeshAxis, axis_index, axis_size
from .spatial import (
    RING_THRESHOLD_TOKENS,
    SPATIAL_AXIS,
    check_sp_rows,
    halo_below_rows,
    halo_exchange_rows,
    shard_rows,
    sp_attention_rows,
    sp_ring_attention_mh,
    sp_ring_attention_rows,
    sp_rows_ok,
    spatial_decode,
    spatial_encode,
    using_sp_axis,
)
