"""Component registry: backbones, necks, heads and full detectors.

Counterpart of ``multigriddet_tpu/models/registry.py``, kept as the port's
own copy (the port imports nothing of the JAX package).  Components are
``nn.Module`` classes registered by decorator; ``create_model`` builds a
registered detector by name, and ``models/detector.py`` ``build_custom``
composes one from registered parts (``model.type: custom``).
"""

from __future__ import annotations

from typing import Callable, Dict, Type

_BACKBONES: Dict[str, Type] = {}
_NECKS: Dict[str, Type] = {}
_HEADS: Dict[str, Type] = {}
_MODELS: Dict[str, Callable] = {}


def _register(table: Dict[str, Callable], name: str):
    def deco(obj):
        table[name] = obj
        return obj
    return deco


def register_backbone(name: str):
    return _register(_BACKBONES, name)


def register_neck(name: str):
    return _register(_NECKS, name)


def register_head(name: str):
    return _register(_HEADS, name)


def register_model(name: str):
    return _register(_MODELS, name)


def get_backbone(name: str) -> Type:
    if name not in _BACKBONES:
        raise KeyError(
            f'Unknown backbone {name!r}; available: {sorted(_BACKBONES)}')
    return _BACKBONES[name]


def get_neck(name: str) -> Type:
    if name not in _NECKS:
        raise KeyError(f'Unknown neck {name!r}; available: {sorted(_NECKS)}')
    return _NECKS[name]


def get_head(name: str) -> Type:
    if name not in _HEADS:
        raise KeyError(f'Unknown head {name!r}; available: {sorted(_HEADS)}')
    return _HEADS[name]


def create_model(name: str, **kwargs):
    """Instantiate a registered detector by name, in eval mode (the
    trainer switches it to training)."""
    if name not in _MODELS:
        raise KeyError(f'Unknown model {name!r}; available: {sorted(_MODELS)}')
    return _MODELS[name](**kwargs).eval()


def list_components() -> Dict[str, list]:
    return {
        'backbones': sorted(_BACKBONES),
        'necks': sorted(_NECKS),
        'heads': sorted(_HEADS),
        'models': sorted(_MODELS),
    }


def list_available_models() -> Dict[str, list]:
    """Alias of :func:`list_components` (the JAX package's name for it)."""
    return list_components()
