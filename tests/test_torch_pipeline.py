"""The port's input pipeline against the JAX generator, on the CPU.

Eight PIL-written JPEGs of mixed sizes through the JAX and the port's
``MultiGridDataGenerator`` with the same seed: batch order, epoch shuffles,
multi-scale canvases, the link-format bytes and the boxes are exact; the
processed batches' targets are exact in their discrete fields (cell,
objectness, anchor and class one-hots) and within 1e-6 in the offsets and
log-ratios; the images within 1e-6 on [0, 1] (yuv420: 4e-7 of the inverse's
1e-4 on a 0-255 scale, as ``test_torch_decode_nms.py`` holds it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multigriddet_tpu.data import augment as jaugment
from multigriddet_tpu.data.pipeline import \
    MultiGridDataGenerator as JaxGenerator
from multigriddet_tpu_torch.data import MultiGridDataGenerator
from multigriddet_tpu_torch.data.augment import (expand_box_capacity,
                                                 normalize_images)
from test_torch_native_oracle import jax_native_oracle  # noqa: F401

ANCHORS = [np.array([[40, 40], [30, 50], [50, 30]], np.float32),
           np.array([[20, 20], [14, 28], [28, 14]], np.float32),
           np.array([[10, 10], [7, 14], [14, 7]], np.float32)]
NC = 3


@pytest.fixture(scope='module')
def lines(tmp_path_factory):
    root = tmp_path_factory.mktemp('pipe')
    rng = np.random.RandomState(3)
    out = []
    for i in range(10):
        h, w = rng.randint(40, 120), rng.randint(40, 120)
        path = root / f'{i}.jpg'
        Image.fromarray(rng.randint(0, 255, (h, w, 3)).astype('uint8')).save(
            path)
        boxes = []
        for _ in range(rng.randint(0, 4)):
            x1, y1 = rng.randint(0, w // 2), rng.randint(0, h // 2)
            boxes.append(f'{x1},{y1},{x1 + rng.randint(4, w // 2)},'
                         f'{y1 + rng.randint(4, h // 2)},{rng.randint(NC)}')
        out.append(' '.join([str(path)] + boxes))
    return out


def _pair(lines, **kw):
    args = dict(anchors=ANCHORS, num_classes=NC, input_shape=(64, 64),
                batch_size=4, max_boxes=6, augment={'enabled': False},
                num_workers=2, **kw)
    return (JaxGenerator(lines, **args),
            MultiGridDataGenerator(lines, device='cpu', **args))


@pytest.mark.parametrize('train,rescale,drop', [
    (True, 1, True), (True, -1, False), (False, -1, True)])
def test_raw_batches_equal_jax(lines, train, rescale, drop):
    """``iter_raw`` over two epochs: the same batches, canvases (multi-scale
    draws), link format (``auto``: yuv420 for a train generator) and bytes,
    the wrap-padded last batch included."""
    jgen, tgen = _pair(lines, train=train, rescale_interval=rescale,
                       drop_remainder=drop)
    assert tgen.link_format == jgen.link_format == (
        'yuv420' if train else 'rgb')
    assert len(tgen) == len(jgen) == (2 if drop else 3)
    shapes = set()
    for _ in range(2):
        got = list(tgen.iter_raw())
        want = list(jgen.iter_raw())
        assert len(got) == len(want) == len(jgen)
        for (tk, tparts, tboxes, thw, gen), (jk, jparts, jboxes, jhw, _) in \
                zip(got, want):
            assert tk == jk == 'host' and thw == jhw
            assert isinstance(gen, torch.Generator)
            shapes.add(thw)
            np.testing.assert_array_equal(tboxes, jboxes)
            assert len(tparts) == len(jparts)
            for a, b in zip(tparts, jparts):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert len(shapes) == (2 if rescale > 0 else 1)


@pytest.mark.parametrize('train', [True, False])
def test_processed_batches_equal_jax(lines, train):
    jgen, tgen = _pair(lines, train=train)
    for (ti, ty, tb), (ji, jy, jb) in zip(tgen, jgen):
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        for a, b in zip(ty, jy):
            a, b = a.numpy(), np.asarray(b)
            np.testing.assert_array_equal(a[..., 4:], b[..., 4:])
            np.testing.assert_allclose(a[..., :4], b[..., :4], rtol=0,
                                       atol=1e-6)


def test_producer_errors_reach_the_consumer(lines):
    _, tgen = _pair(lines)

    def broken(batch_lines, hw):
        raise OSError('disk gone')
    tgen.loader.load_batch = broken
    with pytest.raises(OSError, match='disk gone'):
        next(iter(tgen.iter_raw()))


def test_unported_stage_options_raise(lines):
    """Augmentation and the device bank are ported: a train generator with
    either builds and yields augmented batches (the ops' parity:
    test_torch_augment.py, the bank's: test_torch_bank.py); an evaluation
    generator never augments."""
    args = dict(anchors=ANCHORS, num_classes=NC, input_shape=(64, 64),
                batch_size=4, max_boxes=6, num_workers=2, device='cpu')
    for aug in (None, {'enabled': True}, {'mosaic_prob': 0.3}):
        gen = MultiGridDataGenerator(lines, augment=aug, **args)
        images, _, boxes = next(iter(gen))
        factor = 4 if aug and aug.get('mosaic_prob') else 1
        assert images.shape == (4, 64, 64, 3)
        assert boxes.shape == (4, 6 * factor, 5)
        gen.close()
    gen = MultiGridDataGenerator(lines, augment={'enabled': False},
                                 cache_images_device=True, **args)
    assert gen._dcache is not None
    gen.close()
    gen = MultiGridDataGenerator(lines, train=False, **args)
    _, _, boxes = next(iter(gen))
    assert boxes.shape == (4, 6, 5)
    gen.close()


def test_capacity_and_normalize_equal_jax():
    boxes = np.random.RandomState(1).rand(2, 5, 5).astype(np.float32)
    for factor in (1, 2, 4, 8):
        want = np.asarray(jaugment.expand_box_capacity(jnp.asarray(boxes),
                                                       factor))
        np.testing.assert_array_equal(expand_box_capacity(boxes, factor),
                                      want)
        np.testing.assert_array_equal(
            expand_box_capacity(torch.from_numpy(boxes), factor).numpy(),
            want)
    img = np.random.RandomState(2).rand(2, 4, 4, 3).astype(np.float32) * 255
    np.testing.assert_array_equal(
        normalize_images(torch.from_numpy(img)).numpy(),
        np.asarray(jaugment.normalize_images(jnp.asarray(img))))
