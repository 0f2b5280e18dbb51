"""Meshes, partition rules, collectives with gradients and
sequence-parallel attention.

``mesh``, ``partition`` and ``ring_attention`` are the ports of the
reference's modules of the same names over ``torch.distributed`` (one
process a rank): meshes of named axes, rules cutting a module's
parameters to each rank's shards (``shard_module``), and the ring and
ulysses attention over ``sp``.  ``collectives`` (no reference
counterpart: XLA derives them there) holds the conjugate operators of
tensor and sequence parallelism and the gradient convention over
``sp``; ``data_parallel`` the global batch's view of a dp rank.  The
pipeline (ROADMAP Queue 1 item 9) and FSDP (item 6.1) are not
ported."""

from analytics_zoo_tpu_torch.parallel.mesh import (CANONICAL_AXES, Mesh,
                                                   batch_axes,
                                                   init_distributed,
                                                   make_mesh,
                                                   mesh_batch_size,
                                                   resolve_axis_sizes,
                                                   single_device_mesh)
from analytics_zoo_tpu_torch.parallel.partition import (
    DP_RULES, FSDP_RULES, P, data_process_groups, data_sharding,
    gather_tensor, match_partition_rules, param_placements, shard_module,
    shard_tensor, state_sharding)
from analytics_zoo_tpu_torch.parallel.ring_attention import (
    full_attention, ring_attention, ring_self_attention, ulysses_attention)

__all__ = [
    "CANONICAL_AXES", "Mesh", "batch_axes", "init_distributed",
    "make_mesh", "mesh_batch_size", "resolve_axis_sizes",
    "single_device_mesh", "DP_RULES", "FSDP_RULES", "P",
    "data_process_groups", "data_sharding", "gather_tensor",
    "match_partition_rules", "param_placements", "shard_module",
    "shard_tensor", "state_sharding", "full_attention", "ring_attention",
    "ring_self_attention", "ulysses_attention",
]
