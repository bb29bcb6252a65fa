"""Checkpoints of the whole train state, and weight files.

Counterpart of ``multigriddet_tpu/training/checkpoint.py``.  The JAX package
keeps its checkpoints with orbax; the port keeps the same contract over
``torch.save`` files, one per saved step (``checkpoint_<step>.pt``: the
micro-step count, the model's ``state_dict``, the optimizer with its
schedule count and accumulator, the names of the parameters it trains, the
EMA parameters and the step's metrics), plus an ``index.json`` of the kept
steps and their metrics:

* at most ``max_to_keep`` (5) checkpoints; with ``save_best_only`` the best
  by ``monitor`` are kept, else the latest;
* ``latest_step``, ``best_step``;
* ``restore(allow_mismatch=True)`` of a checkpoint saved on the other side
  of a freeze boundary (another set of trained parameters) restores the
  model, the step and the EMA onto the fresh optimizer;
* ``restore_raw``.

Weight files are flax msgpack bundles (``{'params', 'batch_stats'}``, the
serving format) that the JAX package reads, written by the port's own codec
(``models/weights.py``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..models.weights import (load_flax_variables, load_weights_flexible,
                              msgpack_restore, msgpack_serialize,
                              state_dict_to_flax)
from .state import TrainState

__all__ = ['CheckpointManager', 'load_backbone_flexible', 'load_params',
           'load_weights_flexible', 'model_bundle', 'save_params']


def _trained_names(state: TrainState):
    if state.optimizer is None:
        return None
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for p in state.optimizer.params]


class CheckpointManager:
    """Checkpoint directory with best-metric tracking."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 monitor: str = 'val_loss', mode: str = 'min',
                 save_best_only: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode
        self.save_best_only = save_best_only
        self._index: Dict[int, Dict[str, float]] = {}
        path = os.path.join(self.directory, 'index.json')
        if os.path.exists(path):
            with open(path) as f:
                saved = json.load(f)
            self._index = {int(k): v for k, v in saved.items()
                           if os.path.exists(self._path(int(k)))}

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f'checkpoint_{step}.pt')

    def _write_index(self):
        path = os.path.join(self.directory, 'index.json')
        tmp = path + f'.tmp{os.getpid()}'
        with open(tmp, 'w') as f:
            json.dump({str(k): v for k, v in sorted(self._index.items())}, f)
        os.replace(tmp, path)

    def _rank(self, step: int) -> float:
        """Lower is better; a checkpoint without the metric ranks last."""
        m = self._index[step].get(self.monitor)
        if m is None:
            return float('inf')
        return m if self.mode == 'min' else -m

    def save(self, step: int, state: TrainState,
             metrics: Optional[dict] = None):
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        payload = {
            'step': int(state.step),
            'model': state.model.state_dict(),
            'optimizer': (state.optimizer.state_dict()
                          if state.optimizer is not None else None),
            'trained': _trained_names(state),
            'ema_params': state.ema_params,
            'metrics': metrics,
        }
        path = self._path(step)
        tmp = path + f'.tmp{os.getpid()}'
        torch.save(payload, tmp)
        os.replace(tmp, path)
        self._index[int(step)] = metrics
        steps = sorted(self._index)
        if len(steps) > self.max_to_keep:
            keep = set(sorted(steps, key=self._rank)[:self.max_to_keep]
                       if self.save_best_only
                       else steps[-self.max_to_keep:])
            for s in steps:
                if s not in keep:
                    del self._index[s]
                    os.remove(self._path(s))
        self._write_index()

    def latest_step(self) -> Optional[int]:
        return max(self._index) if self._index else None

    def best_step(self) -> Optional[int]:
        if not self._index:
            return None
        if not self.save_best_only:
            return self.latest_step()
        return min(sorted(self._index), key=self._rank)

    def restore(self, state: TrainState, step: Optional[int] = None,
                allow_mismatch: bool = False) -> TrainState:
        """Restore ``state`` in place (model, optimizer, step, EMA).

        With ``allow_mismatch``, a checkpoint whose optimizer trained
        another set of parameters (saved across a freeze boundary) restores
        the model, the step and the EMA, and keeps ``state``'s fresh
        optimizer: what an unresumed run has at that boundary.
        """
        raw = self.restore_raw(step)
        match = (state.optimizer is not None and raw['optimizer'] is not None
                 and raw['trained'] == _trained_names(state))
        if not match and state.optimizer is not None and not allow_mismatch:
            raise ValueError(
                'the checkpoint optimizer trains other parameters than this '
                'state (saved across a freeze boundary); pass '
                'allow_mismatch=True to restore onto a fresh optimizer')
        state.model.load_state_dict(raw['model'])
        state.step = int(raw['step'])
        if match:
            state.optimizer.load_state_dict(raw['optimizer'])
        elif state.optimizer is not None:
            print('Checkpoint optimizer state does not match this training '
                  'stage (saved across a freeze boundary); restored the '
                  'model and step with a fresh optimizer state')
        if state.ema_params is not None and raw.get('ema_params'):
            for k, v in raw['ema_params'].items():
                state.ema_params[k].copy_(v)
        return state

    def restore_raw(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The checkpoint's payload, on the CPU (no template)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f'no checkpoint found in {self.directory}')
        return torch.load(self._path(step), map_location='cpu')

    def close(self):
        pass


def model_bundle(model: nn.Module,
                 params: Optional[Dict[str, torch.Tensor]] = None):
    """The model as the flax ``{'params', 'batch_stats'}`` tree of numpy
    arrays; ``params`` (e.g. the EMA parameters, by name) replace the
    model's own."""
    sd = dict(model.state_dict())
    if params:
        sd.update(params)
    flax_params, stats = state_dict_to_flax(sd)
    return {'params': flax_params, 'batch_stats': stats}


def save_params(path: str, tree: Any):
    """Write a tree of numpy arrays as a flax msgpack file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'wb') as f:
        f.write(msgpack_serialize(tree))


def load_params(path: str) -> Any:
    with open(path, 'rb') as f:
        return msgpack_restore(f.read())


def load_backbone_flexible(path: str, model: nn.Module) -> nn.Module:
    """Load only the backbone of ``model`` from a weights file holding a
    bare backbone params tree, a full params tree or a
    ``{'params', 'batch_stats'}`` bundle (transfer learning).  Running
    statistics load when the file carries them."""
    raw = load_params(path)
    stats = None
    if isinstance(raw, dict) and 'params' in raw:
        stats = raw.get('batch_stats') or None
        raw = raw['params']
    if isinstance(raw, dict) and 'backbone' in raw:
        stats = (stats or {}).get('backbone') or None
        raw = raw['backbone']
    load_flax_variables(model.backbone, raw, stats)
    return model
