"""Train state, freeze levels and the optimizer wrapper.

Counterpart of ``multigriddet_tpu/training/state.py``.  The JAX package
labels parameters and zeroes the updates of frozen ones with
``optax.multi_transform``; here a frozen parameter has
``requires_grad=False`` and stays out of the optimizer, so it is never
touched.

:class:`TrainOptimizer` gives a ``torch.optim`` optimizer the step
semantics of the optax chain the JAX trainer builds: the learning rate of
update ``n`` is ``schedule(n)``, read before the count advances (optax's
``scale_by_schedule``), and with ``every_k > 1`` the gradients of ``k``
micro-batches are averaged (Welford, as ``optax.MultiSteps``) into one
update per ``k`` calls, the schedule counting updates, not calls.  Under
data parallel (``parallel.distributed``) it sums the gradients over the
ranks once per update, just before the update: each rank's loss is its
share of the global loss, so the sum is the global gradient.  Under a
2-D ``(dp, sp)`` mesh the same world sum holds: each rank's loss is its
band's share, and the row exchanges' backward has already returned each
fetched row's gradient to its owner.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from ..parallel.distributed import all_reduce_grads


class TrainOptimizer:
    """A ``torch.optim`` optimizer driven by a schedule of the update count,
    with optional gradient averaging over ``every_k`` calls."""

    def __init__(self, inner: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]] = None,
                 every_k: int = 1):
        self.inner = inner
        self.schedule = schedule
        self.every_k = max(int(every_k), 1)
        self.count = 0          # updates applied: the schedule's argument
        self.mini_step = 0      # calls since the last update (every_k > 1)
        self._acc: Optional[List[torch.Tensor]] = None

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.inner.param_groups for p in g['params']]

    def step(self) -> bool:
        """Consume the parameters' ``.grad``; returns whether the
        parameters were updated."""
        params = self.params
        if self.every_k > 1:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in params]
            n = self.mini_step
            diff = torch._foreach_sub(grads, self._acc)     # acc + (g -
            torch._foreach_div_(diff, n + 1)                # acc) / (n + 1)
            torch._foreach_add_(self._acc, diff)
            self.mini_step = (n + 1) % self.every_k
            if self.mini_step:
                return False
            for p, a in zip(params, self._acc):
                p.grad = a
            self._acc = None
        all_reduce_grads(params)
        if self.schedule is not None:
            lr = float(self.schedule(self.count))
            for group in self.inner.param_groups:
                group['lr'] = lr
        self.inner.step()
        self.count += 1
        return True

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def set_lr(self, lr: float):
        """Fix the learning rate from now on (reduce-on-plateau); the
        optimizer's moments are kept."""
        self.schedule = None
        for group in self.inner.param_groups:
            group['lr'] = float(lr)

    @property
    def lr(self) -> float:
        return float(self.inner.param_groups[0]['lr'])

    def state_dict(self) -> Dict:
        return {'inner': self.inner.state_dict(), 'count': self.count,
                'mini_step': self.mini_step, 'acc': self._acc}

    def load_state_dict(self, state: Dict):
        self.inner.load_state_dict(state['inner'])
        self.count = int(state['count'])
        self.mini_step = int(state['mini_step'])
        acc = state.get('acc')
        self._acc = None if acc is None else [
            a.to(p.device) for a, p in zip(acc, self.params)]


@dataclasses.dataclass
class TrainState:
    """What a train step reads and updates in place: the step count (micro
    steps included), the model (parameters and BatchNorm statistics), the
    optimizer and, with EMA tracking, the averaged parameters."""

    step: int
    model: nn.Module
    optimizer: Optional[TrainOptimizer]
    # exponential moving average of the parameters (training.ema_decay),
    # keyed by parameter name; None when EMA tracking is off
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def freeze_labels(names, freeze_level: int) -> Dict[str, str]:
    """Label each parameter name 'trainable' or 'frozen'.

    0: everything trains; 1: the backbone is frozen; 2: everything is
    frozen but the predict convs.
    """
    labels = {}
    for name in names:
        if freeze_level <= 0:
            labels[name] = 'trainable'
        elif freeze_level == 1:
            labels[name] = ('frozen' if name.startswith('backbone')
                            else 'trainable')
        else:
            labels[name] = ('trainable' if 'PredictConv' in name
                            else 'frozen')
    return labels


def apply_freeze(model: nn.Module, freeze_level: int) -> List[torch.Tensor]:
    """Set ``requires_grad`` by :func:`freeze_labels`; returns the
    trainable parameters, in ``named_parameters`` order."""
    named = dict(model.named_parameters())
    labels = freeze_labels(named, freeze_level)
    trainable = []
    for name, p in named.items():
        p.requires_grad_(labels[name] == 'trainable')
        if labels[name] == 'trainable':
            trainable.append(p)
    return trainable


def ema_copy(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of every parameter, the EMA's seed."""
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def create_train_state(model: nn.Module,
                       optimizer: Optional[TrainOptimizer],
                       ema: bool = False) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer,
                      ema_params=ema_copy(model) if ema else None)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
