"""Device calls of the loops that have no meaning off the card: on the
CPU (the harness's own tests) they do nothing or read 0."""

from __future__ import annotations

import contextlib

import torch


def sync(dev) -> None:
    if torch.device(dev).type == 'cuda':
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    if torch.device(dev).type == 'cuda':
        return int(torch.cuda.max_memory_allocated(dev))
    return 0


def empty_cache(dev) -> None:
    if torch.device(dev).type == 'cuda':
        torch.cuda.empty_cache()


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the reference's convolutions and matrix products."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
