"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card (``cuda``).  There is no silent CPU path: with
    no GPU present, only an explicit CPU request (``device='cpu'``) runs.
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run the '
            'plain PyTorch path on the CPU')
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {dev}')
    return dev


def to_device(x, device, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """A numpy array or CPU tensor on ``device`` without a host sync.

    A plain host-to-card copy synchronizes the stream first, which would
    stall the host behind every queued step; this one goes through pinned
    memory and ``non_blocking``, so it queues behind them instead.
    """
    t = torch.as_tensor(x, dtype=dtype)
    device = torch.device(device)
    if device.type == 'cuda' and t.device.type == 'cpu':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
