"""Seeded weights for the reference network, made on the device in a few
large calls, and their hand-over to the port's model.

Convolutions are LeCun-normal (standard deviation ``1/sqrt(fan_in)``);
BatchNorm's scale is uniform in [0.8, 1.2] and its bias normal with
standard deviation 0.1; its running statistics are then set to the
moments of each layer's input over the seed's first batch
(:func:`calibrate`), as a trained network's are, uncentred; each layer
then gets a running mean ``m`` of ``MEAN_SCALE`` standard deviations
drawn from the seed, folded into its bias (``bias += m * scale *
rsqrt(var + eps)``), so the function is the same and inference's mean
term carries a full-size share of every output.  Two choices keep the
random network as well conditioned as a trained one, so that the float32
reference and a sound bfloat16 program agree closely (``PERF.md``): the
BatchNorm that ends each residual branch scales by a tenth of that
(``RESIDUAL_SCALE``), so the 23 residual blocks of either backbone do not
compound rounding, and the predict convs' rows are scaled per output
(``PREDICT_GAIN``: box centre 1, box size 0.3, objectness, anchor and
class logits 3), so scores spread over (0, 1) and box sizes stay near
their anchors.  The predict convs' biases are normal with standard
deviation 0.1.
The same tensors go to the reference and, through ``load_state_dict``, to
the port: the port's entries are taken in the order its model registers
them, which is the order the units run, and each shape must agree.
"""

from __future__ import annotations

import math

import torch

from bench_port.harness.device import float32_exact
from bench_port.harness.frames import generator
from bench_port.reference.model import BN_EPS

RESIDUAL_SCALE = 0.1
# a live running mean, in standard deviations of the layer's input
MEAN_SCALE = 0.5
# per output channel of a predict conv: x, y, w, h, objectness, then the
# anchor and class logits
PREDICT_GAIN = (1.0, 1.0, 0.3, 0.3)
LOGIT_GAIN = 3.0


def fill(net, seed: int, device) -> None:
    """Give every unit of ``net`` its seeded float32 tensors on
    ``device``."""
    g = generator(seed, device)
    n_w = sum(math.prod(u.shapes()[0]) for u in net.units)
    n_c = sum(u.cout for u in net.units if not u.predict)
    n_b = sum(u.cout for u in net.units if u.predict)
    normal = torch.randn(n_w + 2 * n_c + n_b, generator=g, device=device)
    uniform = torch.rand(2 * n_c, generator=g, device=device)
    pw, pc, pb = 0, 0, 0
    for u in net.units:
        shape = u.shapes()[0]
        size = math.prod(shape)
        fan_in = shape[1] * shape[2] * shape[3]
        u.weight = normal[pw:pw + size].view(shape) / math.sqrt(fan_in)
        pw += size
        if u.predict:
            gain = torch.full((u.cout,), LOGIT_GAIN, device=device)
            gain[:len(PREDICT_GAIN)] = torch.tensor(PREDICT_GAIN,
                                                    device=device)
            u.weight = u.weight * gain[:, None, None, None]
            u.bias = 0.1 * normal[n_w + 2 * n_c + pb:
                                  n_w + 2 * n_c + pb + u.cout]
            pb += u.cout
            continue
        c = u.cout
        u.gamma = 0.8 + 0.4 * uniform[pc:pc + c]
        if u.residual:
            u.gamma = RESIDUAL_SCALE * u.gamma
        u.var = 0.5 + uniform[n_c + pc:n_c + pc + c]
        u.beta = 0.1 * normal[n_w + pc:n_w + pc + c]
        u.mean = 0.1 * normal[n_w + n_c + pc:n_w + n_c + pc + c]
        pc += c


def calibrate(net, canvases, seed: int) -> None:
    """Running statistics from uint8 canvases ``[B, H, W, 3]`` (a tensor
    on the device), in float32 with TF32 off, then a seeded running mean
    folded into each BatchNorm's bias."""
    with float32_exact():
        net.calibrate(canvases.float() / 255.0)
    bns = [u for u in net.units if not u.predict]
    g = generator(seed + 1, canvases.device)
    draw = torch.randn(sum(u.cout for u in bns), generator=g,
                       device=canvases.device)
    at = 0
    for u in bns:
        m = MEAN_SCALE * u.var.sqrt() * draw[at:at + u.cout]
        at += u.cout
        u.beta = u.beta + m * u.gamma * torch.rsqrt(u.var + BN_EPS)
        u.mean = m


def port_state(model, net) -> dict:
    """The port's ``state_dict`` entries (without BatchNorm's batch
    counters) paired with the reference's tensors, in order."""
    keys = [k for k in model.state_dict()
            if not k.endswith('num_batches_tracked')]
    ours = [t for u in net.units for t in u.tensors()]
    if len(keys) != len(ours):
        raise ValueError(f'the port has {len(keys)} weight entries, the '
                         f'reference {len(ours)}')
    own = model.state_dict()
    for k, t in zip(keys, ours):
        if tuple(own[k].shape) != tuple(t.shape):
            raise ValueError(f'{k}: port shape {tuple(own[k].shape)}, '
                             f'reference {tuple(t.shape)}')
    return dict(zip(keys, ours))


def load_port(model, net) -> None:
    """Copy the reference's weights into the port's model."""
    with torch.no_grad():
        model.load_state_dict(port_state(model, net), strict=False)
