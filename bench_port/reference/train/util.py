"""Helpers of the frozen copies, written out so that the reference imports
nothing of the program: host-to-device copies, the (w, h) IoL of the
anchor match, the MultiGridDet coordinate activation, and the single
process's stand-ins for the program's data-parallel sums and spatial
partition (one process, no partition)."""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-8


def to_device(x, device, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype).to(device)


def iol_wh(boxes_wh: torch.Tensor, anchors_wh: torch.Tensor) -> torch.Tensor:
    """Intersection over the larger area of ``[..., N, 2]`` boxes and
    ``[M, 2]`` anchors with a shared centre: ``[..., N, M]``."""
    b = boxes_wh[..., :, None, :]
    inter = torch.minimum(b, anchors_wh)
    inter_area = inter[..., 0] * inter[..., 1]
    box_area = boxes_wh[..., :, None, 0] * boxes_wh[..., :, None, 1]
    anchor_area = anchors_wh[:, 0] * anchors_wh[:, 1]
    return inter_area / (torch.maximum(box_area, anchor_area) + EPS)


def xy_activation(t: torch.Tensor) -> torch.Tensor:
    return torch.tanh(0.15 * t) + torch.sigmoid(0.15 * t)


def all_sum(x):
    return x


def world_size() -> int:
    return 1


class _NoPartition:
    @staticmethod
    def current():
        return None

    @staticmethod
    def halo_rows(*args, **kwargs):
        raise RuntimeError('the reference runs no spatial partition')


spatial = _NoPartition()
