"""Parallelism of the port over ``torch.distributed``: the counterpart of
``causal_gen_tpu/parallel`` (the same exports), plus the spatial and tensor
parallel pieces that GSPMD supplied there."""

from causal_gen_tpu_torch.parallel.distributed import (
    host_shard_indices,
    initialize_multihost,
    make_global_batch,
)
from causal_gen_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    param_partition_spec,
    replicate,
    shard_batch,
    shard_batch_spatial,
    shard_params_tp,
    spatial_sharding,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "batch_sharding",
    "shard_batch",
    "replicate",
    "spatial_sharding",
    "shard_batch_spatial",
    "param_partition_spec",
    "shard_params_tp",
    "initialize_multihost",
    "host_shard_indices",
    "make_global_batch",
]
