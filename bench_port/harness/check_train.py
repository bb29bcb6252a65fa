"""The correctness numbers of a train cell: the program's first optimizer
steps from the bank against the plain reference's (``reference/train/
replay.py``) from the same weights, files and seed.

* ``first_loss_gap``: the gap between the program's first loss and the
  reference's, over the reference's (``loss_gap``: the largest over the
  steps followed);
* ``grad_gap_median``: the first gradient as the program's Adam holds it
  (its first moment over ``1 - beta1``) against the reference's: for
  each leaf the gap between the two norms, over the larger of the
  reference's norm of that leaf and the median leaf's; the median leaf
  (``grad_gap``: the worst leaf);
* ``change_gap_median``: the parameters' change over the steps followed,
  leaf by leaf as above, over the leaves whose reference gradient is at
  least a thousandth of the median leaf's (the others move under Adam by
  round-off alone); the median leaf (``change_gap``: the worst);
* ``stats_gap_median``: the running statistics' change over the steps
  followed (every BatchNorm's running mean and variance), for each leaf
  the norm of the difference between the program's change and the
  reference's, over the larger of the reference's norm and the median
  leaf's; the median leaf (``stats_gap``: the worst).

The cell's check file names the numbers compared; ``PERF.md`` gives the
readings of all eight and why the ones compared were chosen.

``FAULTS`` are planted in the program's step by the harness's tests and
by ``calibrate.py`` only: each has to fail one number.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import torch

from bench_port.reference.train import replay

NUMBERS = ('first_loss_gap', 'grad_gap_median', 'change_gap_median',
           'stats_gap_median', 'loss_gap', 'grad_gap', 'change_gap',
           'stats_gap')
GRAD_FLOOR = 1e-3


def seed32(seed: int) -> int:
    """The generator's ``numpy`` seed (``RandomState`` takes 32 bits)."""
    return int(seed) % (1 << 32)


def _leaf_gaps(prog: List[torch.Tensor], ref: List[torch.Tensor],
               keep=None):
    """Per leaf, the gap between the two norms over the larger of the
    reference's norm and the median leaf's."""
    p = torch.stack([t.double().norm() for t in prog])
    r = torch.stack([t.double().norm() for t in ref])
    gap = (p - r).abs() / torch.clamp_min(r, r.median())
    return gap[keep] if keep is not None else gap


def _diff_gaps(prog: List[torch.Tensor], ref: List[torch.Tensor]):
    """Per leaf, the norm of the difference over the larger of the
    reference's norm and the median leaf's."""
    d = torch.stack([(p.double() - r.double()).norm()
                     for p, r in zip(prog, ref)])
    r = torch.stack([t.double().norm() for t in ref])
    return d / torch.clamp_min(r, r.median())


def compare(net, start, names, program: Dict, lines, seed, config, traffic,
            dev) -> Dict[str, float]:
    """Run the reference from ``start`` (the trainables before any step,
    in ``net``'s unit order) and compare ``program``'s readings;
    ``net``'s running statistics are still the ones both started from."""
    stats0 = [t.detach().cpu().clone() for t in net.running()]
    net.checkpoint = True
    from bench_port.harness.device import float32_exact
    with float32_exact():
        ref = replay.run(net, lines, seed32(seed), config, traffic,
                         len(program['losses']), dev)
    if len(names) != len(ref['grads']):
        raise ValueError('the program and the reference hold different '
                         'leaves')
    losses = torch.tensor(program['losses'], dtype=torch.float64)
    ref_losses = torch.tensor(ref['losses'], dtype=torch.float64)
    g_ref = [g.cpu() for g in ref['grads']]
    r_norm = torch.stack([g.double().norm() for g in g_ref])
    keep = r_norm >= GRAD_FLOOR * r_norm.median()
    d_prog = [p - s.cpu() for p, s in zip(program['params'], start)]
    d_ref = [p.cpu() - s.cpu() for p, s in zip(ref['params'], start)]
    loss = (losses - ref_losses).abs() / ref_losses.abs()
    grad = _leaf_gaps(program['grads'], g_ref)
    change = _leaf_gaps(d_prog, d_ref, keep)
    stats = _diff_gaps([p - s for p, s in zip(program['stats'], stats0)],
                       [r.cpu() - s for r, s in zip(ref['stats'], stats0)])
    kept = [n for n, k in zip(names, keep.tolist()) if k]
    print(f'worst leaves: gradient {names[int(grad.argmax())]} '
          f'{float(grad.max())!r}, change {kept[int(change.argmax())]} '
          f'{float(change.max())!r}; losses {program["losses"]} against '
          f'{ref["losses"]}', file=sys.stderr)
    return {
        'loss_gap': float(loss.max()),
        'grad_gap': float(grad.max()),
        'change_gap': float(change.max()),
        'first_loss_gap': float(loss[0]),
        'grad_gap_median': float(grad.median()),
        'change_gap_median': float(change.median()),
        'stats_gap': float(stats.max()),
        'stats_gap_median': float(stats.median()),
    }


def _unchanged(prog, step):
    def wrapped(item):
        state = [p for _, p in prog.named_params()] + prog.running()
        before = [t.detach().clone() for t in state]
        metrics = step(item)
        with torch.no_grad():
            for t, b in zip(state, before):
                t.copy_(b)
        return metrics
    return wrapped


def _half_batch(prog, step):
    def wrapped(item):
        banks, idx, boxes, hw, g = item
        h = len(idx) // 2
        return step((banks, idx[:h], boxes[:h], hw, g))
    return wrapped


def _boxes(prog, step):
    def wrapped(item):
        banks, idx, boxes, hw, g = item
        boxes = boxes.copy()
        alive = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3]
                                                   - boxes[..., 1]) > 0
        boxes[..., [0, 2]] += 64.0 * alive[..., None]
        return step((banks, idx, boxes, hw, g))
    return wrapped


# a step that returns its state unchanged; half of the batch left out
# (the mean taken over the rest); every box of the batch moved two coarse
# cells where the generator produces it
FAULTS = {'unchanged': _unchanged, 'half_batch': _half_batch,
          'boxes': _boxes}


def planted(prog, fault):
    if fault is None:
        return prog.step
    return FAULTS[fault](prog, prog.step)
