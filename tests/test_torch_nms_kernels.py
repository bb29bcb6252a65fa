"""The plain versions of the two CUDA NMS kernels against the Pallas kernels
they replace (interpret mode on the CPU), and the kernels against their
plain versions on a card.  JAX is imported by the tests that use it, so
the card's tests also run where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_nms_kernels.py``.

Keep sets, order, classes, boxes and scores must be exact, ties included:
the plain versions repeat the Pallas kernels' float32 arithmetic, and the
outputs are copies of the inputs.
"""

import numpy as np
import pytest
import torch

from multigriddet_tpu_torch.ops import cuda_nms

CASES = [('standard', False), ('standard', True), ('diou', True)]


@pytest.fixture(scope='module')
def jnp():
    return pytest.importorskip('jax.numpy')


@pytest.fixture(scope='module')
def pallas():
    return pytest.importorskip('multigriddet_tpu.ops.pallas_nms')


def _pool(seed, b=2, n=300, nc=20):
    rng = np.random.RandomState(seed)
    boxes = rng.rand(b, n, 4).astype(np.float32) * 300
    boxes[..., 2:] = rng.rand(b, n, 2).astype(np.float32) * 90 + 5
    scores = rng.rand(b, n).astype(np.float32)
    scores[:, 50:60] = scores[:, 40:50]        # exact-tie armies
    scores[:, 200:230] = scores[0, 7]          # one score shared by 30 boxes
    classes = rng.randint(0, nc, (b, n)).astype(np.int32)
    return boxes, scores, classes


def _assert_popmax_equal(got, want):
    gb, gc, gs, gv = (np.asarray(t) for t in got)
    wb, wc, ws, wv = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gc[wv], wc[wv])
    np.testing.assert_array_equal(gb[wv], wb[wv])
    np.testing.assert_array_equal(gs[wv], ws[wv])
    np.testing.assert_array_equal(gs[~wv], ws[~wv])


@pytest.mark.parametrize('method,use_iol', CASES)
def test_popmax_plain_matches_pallas(jnp, pallas, method, use_iol):
    boxes, scores, classes = _pool(0)
    kw = dict(max_boxes=50, method=method, use_iol=use_iol)
    want = pallas.pallas_popmax_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), 0.05,
        0.45, interpret=True, **kw)
    got = cuda_nms.popmax_nms(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              torch.from_numpy(classes), 0.05, 0.45, **kw)
    assert int(got[3].sum()) > 10
    _assert_popmax_equal([t.numpy() for t in got], want)


def test_popmax_plain_exhausts_pool_like_pallas(jnp, pallas):
    """More outputs than survivors: the tail slots are invalid in both."""
    boxes, scores, classes = _pool(1, n=60)
    want = pallas.pallas_popmax_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), 0.5,
        0.3, max_boxes=64, method='diou', use_iol=True, interpret=True)
    got = cuda_nms.popmax_nms_plain(torch.from_numpy(boxes),
                                    torch.from_numpy(scores),
                                    torch.from_numpy(classes), 0.5, 0.3,
                                    max_boxes=64)
    assert 0 < int(got[3].sum()) < 2 * 64
    _assert_popmax_equal([t.numpy() for t in got], want)


def test_popmax_plain_all_below_confidence(jnp, pallas):
    boxes, _, classes = _pool(2, b=1, n=200)
    scores = np.full((1, 200), 0.01, np.float32)
    got = cuda_nms.popmax_nms(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              torch.from_numpy(classes), 0.1, 0.45,
                              max_boxes=20)
    want = pallas.pallas_popmax_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), 0.1,
        0.45, max_boxes=20, interpret=True)
    assert not got[3].any()
    np.testing.assert_array_equal(got[2].numpy(), np.full((1, 20), -1e9,
                                                          np.float32))
    _assert_popmax_equal([t.numpy() for t in got], want)


@pytest.mark.parametrize('method,use_iol', CASES)
def test_greedy_plain_matches_pallas(jnp, pallas, method, use_iol):
    """The JAX wrapper takes one image (the JAX package vmaps it); the
    port's takes the batch."""
    rng = np.random.RandomState(3)
    b, k = 3, 160
    xy = rng.rand(b, k, 2).astype(np.float32) * 200
    wh = rng.rand(b, k, 2).astype(np.float32) * 80 + 5
    boxes = np.concatenate([xy, wh], -1)
    boxes[:, 100:110] = boxes[:, 90:100]       # exact duplicates
    valid = rng.rand(b, k) > 0.1
    got = cuda_nms.greedy_nms(torch.from_numpy(boxes),
                              torch.from_numpy(valid), 0.45, method,
                              use_iol).numpy()
    for i in range(b):
        want = np.asarray(pallas.pallas_greedy_nms(
            jnp.asarray(boxes[i]), jnp.asarray(valid[i]), 0.45, method,
            use_iol, interpret=True))
        np.testing.assert_array_equal(got[i], want)
    assert 0 < got.sum() < valid.sum()


def test_greedy_plain_all_invalid(jnp, pallas):
    boxes = torch.zeros(2, 64, 4)
    valid = torch.zeros(2, 64, dtype=torch.bool)
    assert not cuda_nms.greedy_nms(boxes, valid, 0.5).any()
    want = pallas.pallas_greedy_nms(jnp.zeros((64, 4)),
                                    jnp.zeros((64,), bool), 0.5,
                                    interpret=True)
    assert not np.asarray(want).any()


def test_kernel_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError, match='methods'):
        cuda_nms.popmax_nms(torch.zeros(1, 4, 4), torch.zeros(1, 4),
                            torch.zeros(1, 4, dtype=torch.int32), 0.1, 0.5,
                            method='soft')
    with pytest.raises(ValueError, match='CUDA'):
        cuda_nms._check_cuda_inputs(torch.zeros(1, 4, 4))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version on the same tensors
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc (the kernels build at '
                    'first use)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('method,use_iol', CASES)
def test_popmax_kernel_matches_plain(cuda_device, method, use_iol):
    boxes, scores, classes = (torch.from_numpy(a).to(cuda_device)
                              for a in _pool(4, b=4, n=7581, nc=80))
    before = cuda_nms.popmax_nms.launches
    got = cuda_nms.popmax_nms(boxes, scores, classes, 0.05, 0.45,
                              max_boxes=100, method=method, use_iol=use_iol)
    want = cuda_nms.popmax_nms_plain(boxes, scores, classes, 0.05, 0.45,
                                     max_boxes=100, method=method,
                                     use_iol=use_iol)
    torch.cuda.synchronize()
    assert cuda_nms.popmax_nms.launches == before + 1
    _assert_popmax_equal([t.cpu().numpy() for t in got],
                         [t.cpu().numpy() for t in want])


@pytest.mark.cuda
@pytest.mark.parametrize('k', [1024, 7581])
def test_greedy_kernel_matches_plain(cuda_device, k):
    rng = np.random.RandomState(5)
    boxes = np.concatenate([rng.rand(2, k, 2) * 600, rng.rand(2, k, 2) * 90
                            + 5], -1).astype(np.float32)
    valid = rng.rand(2, k) > 0.05
    boxes, valid = (torch.from_numpy(a).to(cuda_device)
                    for a in (boxes, valid))
    got = cuda_nms.greedy_nms(boxes, valid, 0.45, 'diou', True)
    want = cuda_nms.greedy_nms_plain(boxes, valid, 0.45, 'diou', True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
