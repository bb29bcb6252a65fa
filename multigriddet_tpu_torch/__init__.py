"""MultiGridDet on PyTorch and CUDA (NVIDIA Hopper).

A port of ``multigriddet_tpu`` that keeps its module layout and names, so
each function's counterpart sits at the same relative path.  Plain tensor
code is PyTorch; the two Pallas NMS kernels of the JAX package are CUDA
kernels written for ``sm_90a`` (``csrc/nms.cu``, bound in
``ops/cuda_nms.py``).  This package never imports JAX or the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``
(see :func:`resolve_device`).

The subpackages load on first use, so ``import multigriddet_tpu_torch``
stays cheap, and so do the JAX package's top-level names
``create_model``, ``list_available_models`` and ``draw_boxes``.
"""

from .device import resolve_device

__version__ = '0.1.0'

_SUBPACKAGES = ('ops', 'models', 'losses', 'data', 'config', 'training',
                'inference', 'evaluation', 'postprocess', 'parallel',
                'utils', 'validate')

_CONVENIENCE = {
    'create_model': ('models', 'create_model'),
    'list_available_models': ('models', 'list_available_models'),
    'draw_boxes': ('utils', 'draw_boxes'),
}

__all__ = ['resolve_device', *_CONVENIENCE]


def __getattr__(name):
    import importlib
    if name in _SUBPACKAGES:
        module = importlib.import_module(f'.{name}', __name__)
        globals()[name] = module
        return module
    if name in _CONVENIENCE:
        subpkg, attr = _CONVENIENCE[name]
        value = getattr(importlib.import_module(f'.{subpkg}', __name__),
                        attr)
        globals()[name] = value
        return value
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def __dir__():
    return sorted(set(globals()) | set(_SUBPACKAGES) | set(_CONVENIENCE))
