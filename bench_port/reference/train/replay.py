"""The plain reference of the train cell's first optimizer steps.

Given the cell's annotation lines (JPEG files the benchmark wrote), its
seed, the training block and the starting weights in a reference
:class:`~bench_port.reference.model.Net`, this works out again what the
program's generator and fused bank step do in the first steps from the
device bank, in float32 with TF32 off:

* the batches: the generator's ``numpy`` ``RandomState(seed)`` shuffles
  the lines once per epoch; epoch 1 fills the bank, epoch 2's first
  batches are the ones trained (``batch_lines``);
* the pixels: each file decoded (Pillow), letterboxed onto the gray
  canvas (bilinear, scale ``min(H / h, W / w)``, centred), packed into
  the yuv420 link format (the frozen ``yuv.rgb_to_yuv420_np``), with the
  boxes moved onto the canvas;
* the augmentation draws: the generator's ``torch.Generator(seed)`` is
  split once per batch (epoch 1's batches included), and the batch's
  split feeds the frozen ``chain.draw_chain``;
* the device stage (the frozen ``chain._device_stage``), the train-mode
  forward (BatchNorm on the batch's moments), the frozen MultiGridLoss,
  the backward and Adam (``torch.optim.Adam`` with the schedule's rate of
  each update, read before the update as the program's optimizer reads
  it).

Returns each step's loss, the first step's gradient and the parameters
after the last step, by the reference's own trainables (conv weights,
BatchNorm scales and biases, predict weights and biases, in unit order),
and every BatchNorm's running mean and variance after the last step (moved
once a step by the batch's moments at the program's momentum,
``BN_MOMENTUM``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import chain, setup
from .loss import multigrid_loss
from .yuv import rgb_to_yuv420_np

GRAY = 128
# flax's BatchNorm momentum, the program's default
BN_MOMENTUM = 0.99


def epoch_orders(n_lines: int, seed32: int, epochs: int) -> List[np.ndarray]:
    rng = np.random.RandomState(seed32)
    out = []
    for _ in range(epochs):
        order = np.arange(n_lines)
        rng.shuffle(order)
        out.append(order)
    return out


def batch_lines(lines: Sequence[str], batch: int, seed32: int, k: int):
    """The lines of epoch 2's batch ``k`` (epoch 1 fills the bank)."""
    order = epoch_orders(len(lines), seed32, 2)[1]
    return [lines[i] for i in order[k * batch:(k + 1) * batch]]


def batch_generators(seed32: int, before: int, count: int):
    """The per-batch generators of ``count`` batches after ``before``
    batches: one ``split_generator`` of the generator's own per batch."""
    g = torch.Generator().manual_seed(seed32)
    for _ in range(before):
        chain.split_generator(g)
    return [chain.split_generator(g) for _ in range(count)]


def load_batch(lines: Sequence[str], hw, max_boxes: int):
    """yuv420 planes ``(y, cb, cr)`` uint8 numpy and boxes ``[B,
    max_boxes, 5]`` float32 canvas pixels."""
    from PIL import Image
    th, tw = hw
    canvases, boxes = [], np.zeros((len(lines), max_boxes, 5), np.float32)
    for i, line in enumerate(lines):
        parts = line.split()
        with Image.open(parts[0]) as im:
            rgb = np.asarray(im.convert('RGB'))
        h, w = rgb.shape[:2]
        scale = min(tw / w, th / h)
        nw, nh = int(round(w * scale)), int(round(h * scale))
        px, py = (tw - nw) // 2, (th - nh) // 2
        x = torch.from_numpy(rgb.copy()).permute(2, 0, 1)[None].float()
        x = F.interpolate(x, size=(nh, nw), mode='bilinear',
                          align_corners=False)
        canvas = torch.full((3, th, tw), float(GRAY))
        canvas[:, py:py + nh, px:px + nw] = x[0]
        canvases.append(canvas.clamp(0, 255).round().to(torch.uint8)
                        .permute(1, 2, 0).numpy())
        b = np.asarray([[float(v) for v in t.split(',')] for t in parts[1:]],
                       np.float32).reshape(-1, 5)[:max_boxes]
        b[:, [0, 2]] = b[:, [0, 2]] * scale + px
        b[:, [1, 3]] = b[:, [1, 3]] * scale + py
        boxes[i, :len(b)] = b
    return rgb_to_yuv420_np(np.stack(canvases)), boxes


def run(net, lines: Sequence[str], seed32: int, config: dict,
        traffic: dict, steps: int, dev) -> Dict[str, object]:
    """``steps`` optimizer steps of the reference from ``net``'s weights
    (which become the trained leaves)."""
    training = traffic['training']
    aug = dict(training['augmentation'])
    max_boxes = int(aug.pop('max_boxes_per_image'))
    aug.pop('rescale_interval', None)
    batch = int(training['batch_size'])
    hw = tuple(config['input_shape'][:2])
    anchors = [np.asarray(a, np.float32) for a in config['anchors']]
    nc = config['num_classes']
    cfg = setup.loss_config(training)
    cw = torch.as_tensor(setup.class_weights(lines, nc), device=dev)
    updates = len(lines) // batch
    schedule = setup.lr_schedule(training, traffic['lr_schedule'], updates)
    opt_cfg = traffic['optimizer']
    for u in net.units:
        for name in ('weight', 'bias', 'gamma', 'beta'):
            t = getattr(u, name)
            if t is not None:
                setattr(u, name, t.detach().clone().requires_grad_(True))
    params = net.trainables()
    opt = torch.optim.Adam(params, lr=schedule(0),
                           betas=(opt_cfg['beta_1'], opt_cfg['beta_2']),
                           eps=opt_cfg['epsilon'])
    gens = batch_generators(seed32, updates, steps)
    anc = [torch.as_tensor(a, device=dev) for a in anchors]
    losses, grads = [], None
    for k in range(steps):
        blines = batch_lines(lines, batch, seed32, k)
        planes, boxes = load_batch(blines, hw, max_boxes)
        parts = tuple(torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                      for p in planes)
        images, y_true, _ = chain._device_stage(
            parts, boxes, gens[k], aug, anchors, nc, hw, True)
        outs = net(images, train=True)
        total, _ = multigrid_loss(outs, list(y_true), anc, nc, hw, cfg, cw,
                                  strides=(32, 16, 8))
        opt.zero_grad()
        total.backward()
        if k == 0:
            grads = [p.grad.detach().clone() for p in params]
        for group in opt.param_groups:
            group['lr'] = float(schedule(k))
        opt.step()
        net.update_running(BN_MOMENTUM)
        losses.append(float(total.detach()))
        del outs, total, images, y_true
    return {'losses': losses, 'grads': grads,
            'params': [p.detach().clone() for p in params],
            'stats': [t.clone() for t in net.running()]}
