"""The "mesh" of the port: the ranks of the process group.

Counterpart of ``multigriddet_tpu/parallel/mesh.py``.  A 1-D JAX mesh
shards the batch over devices and replicates the parameters; here each
rank holds its own replica on its own GPU, so :func:`replicate` is a
broadcast from rank 0 and :func:`shard_batch` takes the rank's slice of a
global batch.

The 2-D data x spatial mesh (:func:`make_mesh_2d`) lays the ranks out as
JAX reshapes its devices, ``(dp, sp)`` in row-major order: rank ``i * sp
+ j`` is at ``('batch' i, 'space' j)``.  The ``sp`` ranks of a *space
group* hold the same images, each a band of the rows of every feature map
(``parallel/spatial.py`` does the row exchanges); the ``dp`` ranks of a
*batch group* hold different images.  Parameters stay replicated and
gradients are summed over all ``dp * sp`` ranks once per update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .distributed import process_index, world_size
from .spatial import SpaceGroup, band


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

    @property
    def axis_names(self):
        return (self.axis_name,)

    # the batch axis, as a 2-D mesh names it
    dp = property(lambda self: self.size)
    batch_index = property(lambda self: self.rank)
    space = None


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """The ``(dp, sp)`` grid of the process group: this process at
    ``rank``, in batch group ``batch_index`` and at ``space.index`` of its
    space group ``space``; ``batch_group`` joins the ranks at the same
    place of every space group."""

    dp: int
    sp: int
    rank: int
    space: SpaceGroup
    batch_group: Any = None
    axis_names: tuple = ('batch', 'space')

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def shape(self):
        return dict(zip(self.axis_names, (self.dp, self.sp)))

    @property
    def batch_index(self) -> int:
        return self.rank // self.sp


class PartitionSpec(tuple):
    """A placement, as ``jax.sharding.PartitionSpec``: dimension ``i`` of
    an array is split over mesh axis ``self[i]`` (``None``: whole)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f'PartitionSpec{tuple(self)!r}'


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = 'batch') -> Mesh:
    """The 1-D data-parallel mesh of the process group (one rank per
    GPU).  ``devices`` is accepted for the JAX signature; a process drives
    one device, so it must be ``None`` or hold one device."""
    if devices is not None and len(devices) > 1:
        raise ValueError('a process of the port drives one device; run one '
                         'process per GPU (torchrun) instead')
    return Mesh(world_size(), process_index(), axis_name)


def _groups(blocks):
    """One process group per block of ranks, made in the same order on
    every rank (``dist.new_group`` is collective); returns this rank's.
    A block that is the whole world uses the default group."""
    mine, me, world = None, process_index(), world_size()
    for ranks in blocks:
        g = None if len(ranks) == world else dist.new_group(list(ranks))
        if me in ranks:
            mine = g
    return mine


def make_mesh_2d(dp: int, sp: int, devices: Optional[Sequence] = None,
                 axis_names=('batch', 'space')) -> Mesh2D:
    """The 2-D data x spatial mesh over the process group: ``dp * sp``
    must be the number of ranks (one process drives one GPU; the port
    runs every rank).  Ranks ``i * sp .. i * sp + sp - 1`` form space group
    ``i``.  ``devices``, as in :func:`make_mesh`, must be ``None`` or hold
    one device."""
    if devices is not None and len(devices) > 1:
        raise ValueError('a process of the port drives one device; run one '
                         'process per GPU (torchrun) instead')
    dp, sp = int(dp), int(sp)
    world = world_size()
    if dp < 1 or sp < 1 or dp * sp != world:
        raise ValueError(f'a ({dp}, {sp}) mesh needs {dp * sp} ranks; the '
                         f'process group has {world}')
    rank = process_index()
    space_group = batch_group = None
    if world > 1:
        space_group = _groups([range(i * sp, (i + 1) * sp)
                               for i in range(dp)])
        batch_group = _groups([range(j, world, sp) for j in range(sp)])
    return Mesh2D(dp, sp, rank, SpaceGroup(sp, rank % sp, space_group),
                  batch_group, tuple(axis_names))


def image_partition_spec(mesh) -> PartitionSpec:
    """``P('batch', 'space')`` on a 2-D mesh (NHWC images: the batch over
    ``dp``, the rows over ``sp``), ``P('batch')`` on a 1-D one."""
    if 'space' in mesh.axis_names:
        return PartitionSpec('batch', 'space')
    return PartitionSpec('batch')


def spatial_space(mesh) -> Optional[SpaceGroup]:
    """The mesh's space group when it bands the rows over more than one
    rank, else ``None``."""
    space = getattr(mesh, 'space', None)
    return space if space is not None and space.size > 1 else None


def shard_batch(mesh, *arrays, spec: Optional[PartitionSpec] = None):
    """This rank's share of each global array under ``spec`` (default
    ``P('batch')``): dim 0 split evenly over the batch axis and, where
    ``spec`` names ``'space'``, that dimension banded over the space
    group (``spatial.band``, uneven bands allowed)."""
    spec = PartitionSpec('batch') if spec is None else spec
    out = []
    for a in arrays:
        index = []
        for d, axis in enumerate(spec):
            lo, hi = 0, a.shape[d]
            if axis == 'batch':
                if a.shape[d] % mesh.dp:
                    raise ValueError(f'batch {a.shape[d]} does not split '
                                     f'evenly over {mesh.dp} ranks')
                per = a.shape[d] // mesh.dp
                lo, hi = mesh.batch_index * per, (mesh.batch_index + 1) * per
            elif axis == 'space' and mesh.space is not None:
                lo, hi = band(a.shape[d], mesh.space.size, mesh.space.index)
            index.append(slice(lo, hi))
        out.append(a[tuple(index)])
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
