"""MultiGridDet on PyTorch and CUDA (NVIDIA Hopper).

A port of ``multigriddet_tpu`` that keeps its module layout and names, so
each function's counterpart sits at the same relative path.  Plain tensor
code is PyTorch; the two Pallas NMS kernels of the JAX package are CUDA
kernels written for ``sm_90a`` (``csrc/nms.cu``, bound in
``ops/cuda_nms.py``).  This package never imports JAX or the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``
(see :func:`resolve_device`).
"""

from .device import resolve_device

__all__ = ['resolve_device']
