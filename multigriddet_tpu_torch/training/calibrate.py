"""BatchNorm statistics recalibration.

Counterpart of ``multigriddet_tpu/training/calibrate.py``: the running
statistics become the plain average of each batch's moments (the mean and
the biased variance, clipped at 0) over a sweep of batches.  The JAX
function recovers each batch's moments from the running-average update by
measuring every layer's momentum; the port's BatchNorm is its own, so it
reads the moments directly: with the momentum set to 0 for the sweep, a
train-mode forward leaves exactly the batch's moments in the running
buffers.  Under data parallel those are the global batch's moments
(``models/layers.py`` ``batch_norm`` averages them over the ranks), so
every rank derives the same statistics.  Under a 2-D mesh that bands the
rows (``mesh``), each batch is the rank's at the whole canvas and the
forward runs on its band under a spatial partition (``parallel/
spatial.py``): BatchNorm's moments are then the global batch's at the
whole canvas, as the JAX sweep over batches placed ``P('batch',
'space')`` gives them.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

from ..models.layers import ConvBN
from ..parallel import spatial
from ..parallel.mesh import spatial_space


@torch.no_grad()
def calibrate_batch_stats(model: nn.Module, batches: Iterable,
                          max_batches: int = 32, mesh=None) -> nn.Module:
    """Recompute the running statistics of every BatchNorm of ``model`` in
    place over at most ``max_batches`` of ``batches`` (image tensors
    ``[B, H, W, 3]`` in [0, 1], or tuples whose first element is one).
    The model keeps its statistics when ``batches`` is empty."""
    space = spatial_space(mesh)
    blocks = [m for m in model.modules() if isinstance(m, ConvBN)]
    momenta = [m.bn_momentum for m in blocks]
    sums, n = None, 0
    try:
        for m in blocks:
            m.bn_momentum = 0.0
        for item in batches:
            images = item[0] if isinstance(item, (tuple, list)) else item
            with spatial.partitioned(space, images.shape[1]):
                model(spatial.band_of(images, space), train=True)
            stats = [(m.BatchNorm_0.running_mean.clone(),
                      m.BatchNorm_0.running_var.clone()) for m in blocks]
            sums = stats if sums is None else [
                (a + s, b + t) for (a, b), (s, t) in zip(sums, stats)]
            n += 1
            if n >= max_batches:
                break
    finally:
        for m, mom in zip(blocks, momenta):
            m.bn_momentum = mom
    if sums is not None:
        for m, (mean, var) in zip(blocks, sums):
            m.BatchNorm_0.running_mean.copy_(mean / n)
            m.BatchNorm_0.running_var.copy_(torch.clamp_min(var / n, 0.0))
    return model
