"""The fused train step on the card against the same step on the CPU.

Run on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_train_card.py`` (the repo's conftest imports JAX); it skips
where there is no GPU.  The same seeded weights and u8 batch go through the
device stage and ``make_fused_train_step`` on both devices with TF32 off,
with the loss settings of ``configs/train_config.yaml``.

Tolerances.  The encoder's discrete fields equal, its offsets and
log-ratios and the [0, 1] images within 1e-6.  The float32 step (different
conv algorithms sum in different orders, ~1e-6 relative): every loss term
within 1e-4 relative, ``num_positives`` exact, running statistics after
the step within 1e-4 relative (of max(1, |value|)).  Gradients are
compared in float64 from identical images and targets, each within 1e-6
of its tensor's largest |grad|: at a random init a conv before train-mode
BatchNorm gets the small remainder of a large common gradient once the
backward subtracts the batch means, which multiplies any upstream
difference by ~1e6 (on Darknet53 at b2 @128x160 the CPU's own float32
gradients lie up to 1.4e-1 from float64; float64 from two summation
orders agrees to 6e-14).
"""

import copy

import numpy as np
import pytest
import torch

from multigriddet_tpu_torch.data.pipeline import _device_stage
from multigriddet_tpu_torch.losses import LossConfig
from multigriddet_tpu_torch.models import (create_model, load_flax_variables,
                                           random_flax_variables)
from multigriddet_tpu_torch.ops.yuv import rgb_to_yuv420_np
from multigriddet_tpu_torch.training import (TrainOptimizer, apply_freeze,
                                             create_train_state,
                                             make_fused_train_step,
                                             make_train_step)
from multigriddet_tpu_torch.utils.anchors import DEFAULT_COCO_ANCHORS

LOSS = dict(coord_scale=5.0, no_object_scale=0.5, label_smoothing=0.01,
            use_consensus_loss=True, max_gt_boxes=100)


def _batch(seed, b, hw, nc):
    rng = np.random.RandomState(seed)
    pixels = rng.randint(0, 256, (b, *hw, 3)).astype(np.uint8)
    boxes = np.zeros((b, 100, 5), np.float32)
    for i in range(b):
        for t in range(rng.randint(1, 31)):
            w, h = rng.uniform(8, hw[1] / 2), rng.uniform(8, hw[0] / 2)
            x, y = rng.uniform(0, hw[1] - w), rng.uniform(0, hw[0] - h)
            boxes[i, t] = [x, y, x + w, y + h, rng.randint(nc)]
    return pixels, boxes


def _step(model, dev, parts, boxes, nc, anchors, batch=None):
    """The fused step from the u8 ``parts``, or with ``batch`` = (images,
    y_true) the train step from those."""
    m = copy.deepcopy(model).to(dev)
    opt = TrainOptimizer(torch.optim.Adam(apply_freeze(m, 0), lr=1e-4,
                                          eps=1e-7))
    state = create_train_state(m, opt)
    if batch is None:
        host_step, _ = make_fused_train_step(anchors, nc, LossConfig(**LOSS),
                                             aug_cfg={'enabled': False})
        _, metrics = host_step(state, tuple(torch.from_numpy(p).to(dev)
                                            for p in parts), boxes,
                               torch.Generator().manual_seed(0))
    else:
        hw = tuple(batch[0].shape[1:3])
        step = make_train_step(anchors, nc, hw, LossConfig(**LOSS))
        _, metrics = step(state, batch[0].to(dev),
                          [y.to(dev) for y in batch[1]])
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.cpu().double() for n, p in m.named_parameters()},
            {k: v.cpu() for k, v in m.state_dict().items() if 'running' in k})


@pytest.mark.cuda
@pytest.mark.parametrize('arch,hw,nc,link', [
    ('multigriddet_tiny', (64, 64), 3, 'rgb'),
    ('multigriddet_darknet', (128, 160), 80, 'yuv420')])
def test_fused_train_step_card_matches_cpu(arch, hw, nc, link):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU; run with -m cuda on the card')
    model = create_model(arch, num_anchors=(3, 3, 3), num_classes=nc)
    load_flax_variables(model, *random_flax_variables(model, seed=2))
    pixels, boxes = _batch(5, 2, hw, nc)
    parts = (pixels,) if link == 'rgb' else rgb_to_yuv420_np(pixels)
    anchors = [a * (hw[0] / 608) for a in DEFAULT_COCO_ANCHORS]
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model64 = create_model(arch, num_anchors=(3, 3, 3), num_classes=nc,
                           dtype=torch.float64)
    model64.load_state_dict(model.state_dict())
    model64.double()
    stages = []
    for dev in ('cpu', 'cuda'):
        images, y_true, _ = _device_stage(
            tuple(torch.from_numpy(p).to(dev) for p in parts), boxes, None,
            {'enabled': False}, anchors, nc, hw, True)
        stages.append((images.cpu(), [y.cpu() for y in y_true]))
    (ci, cy), (gi, gy) = stages
    assert float((gi - ci).abs().max()) <= 1e-6
    for g, c in zip(gy, cy):
        assert torch.equal(g[..., 4:], c[..., 4:])
        assert float((g[..., :4] - c[..., :4]).abs().max()) <= 1e-6
    try:
        _, rg, _ = _step(model64, 'cpu', parts, boxes, nc, anchors, (ci, cy))
        _, gg, _ = _step(model64, 'cuda', parts, boxes, nc, anchors,
                         (ci, cy))
        cm, _, cs = _step(model, 'cpu', parts, boxes, nc, anchors)
        gm, _, gs = _step(model, 'cuda', parts, boxes, nc, anchors)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    assert gm['num_positives'] == cm['num_positives'] > 0
    for k, want in cm.items():
        assert abs(gm[k] - want) <= 1e-4 * max(abs(want), 1e-6), (k, gm[k],
                                                                   want)
    bad = []
    for n, ref in rg.items():
        err = float((gg[n] - ref).abs().max()) / max(float(ref.abs().max()),
                                                     1e-300)
        if not err <= 1e-6:
            bad.append((n, err))
    assert not bad, bad
    for k, want in cs.items():
        assert float(((gs[k] - want).abs()
                      / want.abs().clamp_min(1.0)).max()) <= 1e-4, k
