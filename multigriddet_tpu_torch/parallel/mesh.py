"""The data-parallel "mesh" of the port: the ranks of the process group.

Counterpart of ``multigriddet_tpu/parallel/mesh.py``.  A 1-D JAX mesh
shards the batch over devices and replicates the parameters; here each
rank holds its own replica on its own GPU, so :func:`replicate` is a
broadcast from rank 0 and :func:`shard_batch` takes the rank's slice of a
global batch.  The 2-D data x spatial mesh has no counterpart yet: every
convolution would need a halo exchange between the ranks that GSPMD wrote
on the TPU (ROADMAP item 18).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .distributed import process_index, world_size

_SPATIAL = ('dp x sp spatial partitioning is not ported (ROADMAP Queue 1 '
            'item 18: every convolution needs a halo exchange between the '
            'ranks)')


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel group as a 1-D mesh: ``size`` ranks along
    ``axis_name``, this process at ``rank``."""

    size: int
    rank: int
    axis_name: str = 'batch'

    @property
    def shape(self):
        return {self.axis_name: self.size}


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = 'batch') -> Mesh:
    """The 1-D data-parallel mesh of the process group (one rank per
    GPU).  ``devices`` is accepted for the JAX signature; a process drives
    one device, so it must be ``None`` or hold one device."""
    if devices is not None and len(devices) > 1:
        raise ValueError('a process of the port drives one device; run one '
                         'process per GPU (torchrun) instead')
    return Mesh(world_size(), process_index(), axis_name)


def make_mesh_2d(dp: int, sp: int, devices=None,
                 axis_names=('batch', 'space')):
    raise NotImplementedError(_SPATIAL)


def image_partition_spec(mesh):
    raise NotImplementedError(_SPATIAL)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's slice along dim 0 of each global-batch array."""
    out = []
    for a in arrays:
        if a.shape[0] % mesh.size:
            raise ValueError(f'batch {a.shape[0]} does not split evenly '
                             f'over {mesh.size} ranks')
        per = a.shape[0] // mesh.size
        out.append(a[mesh.rank * per:(mesh.rank + 1) * per])
    return tuple(out)


@torch.no_grad()
def replicate(mesh: Mesh, tree: Any):
    """Make ``tree`` equal on every rank: rank 0's values are broadcast in
    place into a module's parameters and buffers, a tensor, or the
    tensors of a dict / list / tuple.  Returns ``tree``."""
    if mesh.size <= 1:
        return tree
    if isinstance(tree, nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, torch.Tensor):
        tensors = [tree]
    elif isinstance(tree, dict):
        tensors = [v for v in tree.values() if isinstance(v, torch.Tensor)]
    else:
        tensors = [v for v in tree if isinstance(v, torch.Tensor)]
    for t in tensors:
        dist.broadcast(t.data, src=0)
    return tree
