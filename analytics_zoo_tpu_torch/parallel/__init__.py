"""Meshes, partition rules and the single-device attention reference.

``mesh`` and ``partition`` are the ports of the reference's modules of
the same names over ``torch.distributed`` (one process a rank);
``ring_attention`` holds the plain full attention.  The pipeline,
ring and ulysses paths are not ported (ROADMAP Queue 1 item 9)."""

from analytics_zoo_tpu_torch.parallel.mesh import (CANONICAL_AXES, Mesh,
                                                   batch_axes,
                                                   init_distributed,
                                                   make_mesh,
                                                   mesh_batch_size,
                                                   resolve_axis_sizes,
                                                   single_device_mesh)
from analytics_zoo_tpu_torch.parallel.partition import (
    DP_RULES, FSDP_RULES, P, data_process_groups, data_sharding,
    gather_tensor, match_partition_rules, shard_tensor, state_sharding)

__all__ = [
    "CANONICAL_AXES", "Mesh", "batch_axes", "init_distributed",
    "make_mesh", "mesh_batch_size", "resolve_axis_sizes",
    "single_device_mesh", "DP_RULES", "FSDP_RULES", "P",
    "data_process_groups", "data_sharding", "gather_tensor",
    "match_partition_rules", "shard_tensor", "state_sharding",
]
