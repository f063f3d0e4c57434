"""Spatial (row), data, tensor and ZeRO-3 state parallelism over
``torch.distributed``, the counterpart of ``kandinsky2_tpu/parallel/``:
``mesh`` (the one-axis mesh of the ranks, the ``(data, sp)`` mesh of
sharded training, and the ``(data, model)`` mesh of ``make_mesh`` with the
tensor-parallel rule, its audit, ``shard_params`` and ``shard_pipeline``,
and the FSDP placement ``fsdp_state_shardings``), ``fsdp`` (the sliced
train state, its gathers by unit and the whole-state gather and place),
``tensor_parallel`` (the column- and row-parallel layers),
``collectives`` (ppermute, psum, pmean, all_gather, each differentiable
through its transpose, and the bucketed gradient all-reduce
``pmean_grads``; gloo staging of CUDA tensors), ``spatial`` (halo
convolutions, sharded attention with the ring's K5/K4 backward,
``spatial_decode`` / ``spatial_encode``) and ``launch`` (one process per
shard, with a deadline).
"""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshAxis,
    ShardingReport,
    _fsdp_augment,
    axis_index,
    axis_size,
    data_sharding,
    fsdp_state_shardings,
    make_mesh,
    replicate,
    shard_params,
    shard_pipeline,
)
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
    using_sp_axes,
    using_sp_axis,
)
