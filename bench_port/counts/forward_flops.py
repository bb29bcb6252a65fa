"""Count a configuration's forward FLOPs per image on the plain reference.

    python3 bench_port/counts/forward_flops.py <config> [...]

Runs the reference network of ``bench_port/configs/<config>.json`` once
on meta tensors of one image at the configuration's canvas under
``torch.utils.flop_counter.FlopCounterMode`` (a multiply-add counts two;
convolutions and matrix products only) and prints the count.  The count
is frozen in ``bench_port/counts/<config>.json``: it is the yardstick of
the cells' ``mfu`` shares, so a change to the program cannot move it.
"""

from __future__ import annotations

import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def forward_flops(config: dict) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    from bench_port.reference.model import Net
    net = Net(config['reference'], [len(a) for a in config['anchors']],
              config['num_classes'])
    for u in net.units:
        u.weight, *rest = (torch.empty(s, device='meta') for s in u.shapes())
        if u.predict:
            u.bias = rest[0]
        else:
            u.gamma, u.beta, u.mean, u.var = rest
    h, w = config['input_shape'][:2]
    x = torch.empty(1, h, w, 3, device='meta')
    with FlopCounterMode(display=False) as counter:
        net(x)
    return int(counter.get_total_flops())


def main(argv) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    for name in argv:
        with open(os.path.join(HERE, '..', 'configs', f'{name}.json')) as f:
            print(name, forward_flops(json.load(f)))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
