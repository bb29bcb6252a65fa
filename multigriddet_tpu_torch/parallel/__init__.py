"""Parallelism of the port: one process per GPU under ``torch.distributed``
(counterpart of ``multigriddet_tpu/parallel``): data parallel over a 1-D
mesh, and data x spatial partitioning over a 2-D ``(dp, sp)`` mesh."""

from . import spatial
from .distributed import (all_mean, all_reduce_grads, all_sum,
                          all_sum_metrics, is_multiprocess, is_primary,
                          local_batch_size, local_device, maybe_initialize,
                          process_index, shard_lines, world_size)
from .mesh import (Mesh, Mesh2D, PartitionSpec, image_partition_spec,
                   make_mesh, make_mesh_2d, replicate, shard_batch,
                   spatial_space)

__all__ = [
    'Mesh', 'Mesh2D', 'PartitionSpec', 'all_mean', 'all_reduce_grads',
    'all_sum', 'all_sum_metrics', 'image_partition_spec', 'is_multiprocess',
    'is_primary', 'local_batch_size', 'local_device', 'make_mesh',
    'make_mesh_2d', 'maybe_initialize', 'process_index', 'replicate',
    'shard_batch', 'shard_lines', 'spatial', 'spatial_space', 'world_size',
]
