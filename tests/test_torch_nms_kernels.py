"""The plain versions of the two CUDA NMS kernels against the Pallas kernels
they replace (interpret mode on the CPU), a numpy model of the kernels'
algorithms against the same Pallas kernels, and the kernels against their
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
# numpy model of the kernels' algorithms (csrc/nms.cu), chunks of 64
# ---------------------------------------------------------------------------

CHUNK = 64
FULL = (1 << CHUNK) - 1
HEAD_TARGET, HEAD_CAP = 512, 2048


def _overlaps(rows, cols, method, use_iol):
    """``[R, C]`` overlaps of ``rows [R, 4]`` with ``cols [C, 4]`` in the
    kernels' float32 order (the earlier box first)."""
    return cuda_nms.overlap_rows(torch.from_numpy(rows)[None],
                                 torch.from_numpy(cols)[None], method,
                                 use_iol)[0].numpy()


def _words(hits):
    """Row words of a boolean ``[R, <=64]`` matrix: bit t <=> column t."""
    return [sum(1 << int(t) for t in np.flatnonzero(row)) for row in hits]


def _lowest(bits):
    return (bits & -bits).bit_length() - 1


def _sort_key(s, j):
    """The kernel's 64-bit key: descending score (-0.0 as +0.0) in the high
    word, ascending flat index in the low word."""
    u = int(np.float32(s).view(np.uint32))
    if (u << 1) & 0xffffffff == 0:
        u = 0
    u = (~u & 0xffffffff) if u & 0x80000000 else u | 0x80000000
    return ((~u & 0xffffffff) << 32) | int(j)


def _head_size(keys):
    """Keys in the kernel's head: the two-pass radix select (12 bits of the
    score word a pass) for the HEAD_TARGET smallest keys."""
    word = np.asarray([k >> 32 for k in keys], np.int64)
    h1 = np.bincount(word >> 20, minlength=4096)
    b1 = int(np.searchsorted(np.cumsum(h1), HEAD_TARGET))
    before1 = int(h1[:b1].sum())
    h2 = np.bincount((word[word >> 20 == b1] >> 8) & 0xfff, minlength=4096)
    b2 = int(np.searchsorted(np.cumsum(h2), HEAD_TARGET - before1))
    return before1 + int(h2[:b2 + 1].sum())


def _chunks(keys):
    """Sweep positions: chunks of 64 over the selected head, then, if the
    sweep gets there, chunks of 64 over the rest of the sorted list."""
    live = head = len(keys)
    if live > HEAD_TARGET:
        head = _head_size(keys)
        if head > HEAD_CAP:
            head = live
    return [(a, min(a + CHUNK, head)) for a in range(0, head, CHUNK)] + [
        (a, min(a + CHUNK, live)) for a in range(head, live, CHUNK)]


def _popmax_model(boxes, scores, classes, conf, thr, max_boxes, method,
                  use_iol):
    """Sort the live keys (the selected head first), sweep them in chunks of
    64 (pre-removed bits against the kept list, the chunk's suppression
    words resolved in order), stop at max_boxes, fill the tail with the
    last pop."""
    neg = np.float32(cuda_nms.NEG)
    b, n = scores.shape
    out_b = np.zeros((b, max_boxes, 4), np.float32)
    out_c = np.zeros((b, max_boxes), np.int32)
    out_s = np.zeros((b, max_boxes), np.float32)
    out_v = np.zeros((b, max_boxes), bool)
    for img in range(b):
        s = np.where(scores[img] >= conf, scores[img], neg).astype(np.float32)
        live = np.flatnonzero(s > neg / 2)
        keys = sorted(_sort_key(s[j], j) for j in live)
        order = [k & 0xffffffff for k in keys]
        kept = []
        for start, stop in _chunks(keys):
            if len(kept) == max_boxes:
                break
            idx = np.asarray(order[start:stop])
            cb = boxes[img, idx]
            removed = 0
            if kept:
                pre = (_overlaps(boxes[img, kept], cb, method, use_iol)
                       >= thr).any(0)
                removed = _words(pre[None])[0]
            removed |= FULL & ~((1 << len(idx)) - 1)
            rows = _words(np.triu(_overlaps(cb, cb, method, use_iol) >= thr,
                                  1))
            open_ = FULL & ~removed
            while open_ and len(kept) < max_boxes:
                i = _lowest(open_)
                kept.append(int(idx[i]))
                removed |= rows[i]
                open_ = FULL & ~removed & ~((2 << i) - 1)
        m = len(kept)
        out_b[img, :m] = boxes[img, kept]
        out_c[img, :m] = classes[img, kept]
        out_s[img, :m] = s[kept]
        out_v[img, :m] = True
        if m < max_boxes:
            final = np.full(n, neg, np.float32)
            other = (s <= neg / 2) & (s != neg)
            final[other] = s[other]
            if kept and other.any():
                hit = (_overlaps(boxes[img, kept], boxes[img], method,
                                 use_iol) >= thr).any(0)
                final[other & hit] = neg
            j = int(np.argmax(final))
            out_b[img, m:] = boxes[img, j]
            out_c[img, m:] = classes[img, j]
            out_s[img, m:] = final[j]
    return out_b, out_c, out_s, out_v


def _greedy_model(boxes, valid, thr, method, use_iol):
    """Fill the suppression words of every row, then scan them 64 rows at a
    step: resolve the chunk from its diagonal words, OR the kept rows'
    later words into the removed bits; keep = ~removed."""
    b, k, _ = boxes.shape
    words = -(-k // CHUNK)
    keep = np.zeros((b, k), bool)
    col = np.arange(k)
    for img in range(b):
        ov = _overlaps(boxes[img], boxes[img], method, use_iol)
        hits = (ov >= thr) & (col[None, :] > col[:, None])
        mask = [[_words(hits[i:i + 1, w * CHUNK:(w + 1) * CHUNK])[0]
                 for w in range(words)] for i in range(k)]
        gone = np.ones(words * CHUNK, bool)
        gone[:k] = ~valid[img]
        removed = _words(gone.reshape(words, CHUNK))
        for c in range(words):
            r = removed[c]
            kept = []
            open_ = FULL & ~r
            while open_:
                i = _lowest(open_)
                kept.append(c * CHUNK + i)
                r |= mask[c * CHUNK + i][c]
                open_ = FULL & ~r & ~((2 << i) - 1)
            removed[c] = r
            for row in kept:
                for w in range(c + 1, words):
                    removed[w] |= mask[row][w]
        for j in range(k):
            keep[img, j] = not (removed[j // CHUNK] >> (j % CHUNK)) & 1
    return keep


def _model_pool(case):
    """Pools that stress the sort and the chunked sweep; returns
    ``(boxes, scores, classes, confidence, max_boxes)``."""
    rng = np.random.RandomState(10)
    boxes, scores, classes = _pool(11, b=2, n=200)
    if case == 'ties':               # tie armies, one score shared by 30
        return (*_pool(12, b=2, n=300), 0.05, 60)
    if case == 'signed_zero':        # +-0.0 live at confidence 0
        scores[:, ::3] = 0.0
        scores[:, 1::6] = -0.0
        scores[:, 50:] = np.where(rng.rand(2, 150) < 0.5, 0.0, -0.0)
        return boxes, scores, classes, 0.0, 120
    if case.startswith('live'):     # exactly L live candidates
        live = int(case[4:])
        low = rng.rand(2, 200).astype(np.float32) * 0.09
        low[0, rng.permutation(200)[:live]] = rng.rand(live) * 0.8 + 0.2
        low[1, rng.permutation(200)[:live]] = 0.5    # and all tied
        return boxes, low, classes, 0.1, 150
    if case == 'army':               # 150 identical boxes at the top
        boxes[:, 20:170] = boxes[:, 5:6]
        scores[:, 20:170] = 1.0
        scores[:, 60:90] = 0.99
        return boxes, scores, classes, 0.05, 40
    if case == 'exhausted':          # far more slots than survivors
        boxes[..., 2:] *= 3
        return boxes, scores, classes, 0.3, 120
    if case == 'deep':               # filtered scores in (NEG, NEG/2]:
        # not live, but the tail repeats the best of them that no kept
        # box suppresses
        deep = rng.rand(2, 200) < 0.6
        scores[deep] = (-7e8 - rng.rand(int(deep.sum())) * 1e8)
        boxes[..., 2:] *= 2
        return boxes, scores, classes, -9e8, 100
    if case == 'head':               # past the selected head of 512
        rng = np.random.RandomState(14)
        boxes = np.concatenate([rng.rand(1, 900, 2) * 600,
                                rng.rand(1, 900, 2) * 6 + 2], -1)
        scores = (rng.rand(1, 900) * 0.5).astype(np.float32)
        scores[0, :480] += 0.5
        scores[0, 480:580] = 0.5                   # 100 ties across the cut
        return (boxes.astype(np.float32), scores,
                rng.randint(0, 80, (1, 900)).astype(np.int32), 0.0, 700)
    if case == 'wide_tie':           # more equal scores than the head holds
        rng = np.random.RandomState(15)
        boxes = np.concatenate([rng.rand(1, 2200, 2) * 600,
                                rng.rand(1, 2200, 2) * 60 + 5], -1)
        scores = np.full((1, 2200), 0.5, np.float32)
        scores[0, ::7] = 0.75
        return (boxes.astype(np.float32), scores,
                rng.randint(0, 80, (1, 2200)).astype(np.int32), 0.0, 30)
    if case == 'below':              # nothing clears the confidence
        return boxes, np.full_like(scores, 0.01), classes, 0.1, 30
    raise ValueError(case)


MODEL_POOLS = ['ties', 'signed_zero', 'live63', 'live64', 'live65',
               'live129', 'army', 'exhausted', 'deep', 'head', 'wide_tie',
               'below']


@pytest.mark.parametrize('case', MODEL_POOLS)
def test_popmax_model_matches_pallas(jnp, pallas, case):
    """The sort-and-sweep algorithm of the pop-max kernel, and the plain
    version, equal the Pallas pop-max kernel, tail slots included."""
    boxes, scores, classes, conf, max_boxes = _model_pool(case)
    method, use_iol = ('standard', False) if case == 'live64' else (
        'diou', True)
    want = [np.asarray(a) for a in pallas.pallas_popmax_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), conf,
        0.45, max_boxes=max_boxes, method=method, use_iol=use_iol,
        interpret=True)]
    got = _popmax_model(boxes, scores, classes, conf, 0.45, max_boxes,
                        method, use_iol)
    plain = cuda_nms.popmax_nms(torch.from_numpy(boxes),
                                torch.from_numpy(scores),
                                torch.from_numpy(classes), conf, 0.45,
                                max_boxes, method, use_iol)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(p.numpy(), w)
    if case.startswith('live'):
        assert 0 < got[3].sum(1).max() <= int(case[4:])
        assert (scores >= conf).sum(1).tolist() == [int(case[4:])] * 2
    if case == 'below':
        assert not got[3].any()


def _greedy_case(case):
    rng = np.random.RandomState(13)
    b, k = 2, 150
    xy = rng.rand(b, k, 2).astype(np.float32) * 200
    wh = rng.rand(b, k, 2).astype(np.float32) * 80 + 5
    boxes = np.concatenate([xy, wh], -1)
    valid = np.ones((b, k), bool)
    if case == 'holes':
        boxes[:, 70:100] = boxes[:, 40:70]
        valid = rng.rand(b, k) > 0.3
        valid[:, 60:70] = False
    elif case == 'army':             # one box repeated across three chunks
        boxes[:, 10:140] = boxes[:, 3:4]
    elif case == 'k64':
        boxes, valid = boxes[:, :64].copy(), rng.rand(b, 64) > 0.2
    elif case == 'none':
        valid[:] = False
    return boxes, valid


@pytest.mark.parametrize('case', ['holes', 'army', 'k64', 'none'])
def test_greedy_model_matches_pallas(jnp, pallas, case):
    """The bitmask-and-scan algorithm of the greedy kernels, and the plain
    version, equal the Pallas sweep."""
    boxes, valid = _greedy_case(case)
    got = _greedy_model(boxes, valid, 0.45, 'diou', True)
    plain = cuda_nms.greedy_nms(torch.from_numpy(boxes),
                                torch.from_numpy(valid), 0.45).numpy()
    for i in range(boxes.shape[0]):
        want = np.asarray(pallas.pallas_greedy_nms(
            jnp.asarray(boxes[i]), jnp.asarray(valid[i]), 0.45,
            interpret=True))
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(plain[i], want)
    if case == 'none':
        assert not got.any()
    else:
        assert 0 < got.sum() < valid.sum()


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version on the same tensors
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc (the kernels build at '
                    'first use)')
    return torch.device('cuda')


def _card_pool(case, seed=4):
    """Serving-size pools (b=4, n=7,581), the army of identical boxes at
    the top of the order, and small pools around the chunk width."""
    n = {'n63': 63, 'n65': 65, 'n129': 129}.get(case, 7581)
    boxes, scores, classes = _pool(seed, b=4, n=max(n, 300), nc=80)
    boxes, scores, classes = boxes[:, :n], scores[:, :n], classes[:, :n]
    if case == 'army':
        boxes[:, 3000:4000] = boxes[:, 3000:3001]
        scores[:, 3000:4000] = 1.0
    return [np.ascontiguousarray(a) for a in (boxes, scores, classes)]


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['serving', 'army', 'n63', 'n65', 'n129'])
@pytest.mark.parametrize('method,use_iol', CASES)
def test_popmax_kernel_matches_plain(cuda_device, method, use_iol, case):
    boxes, scores, classes = (torch.from_numpy(a).to(cuda_device)
                              for a in _card_pool(case))
    before = cuda_nms.popmax_nms.launches
    got = cuda_nms.popmax_nms(boxes, scores, classes, 0.05, 0.45,
                              max_boxes=100, method=method, use_iol=use_iol)
    want = cuda_nms.popmax_nms_plain(boxes, scores, classes, 0.05, 0.45,
                                     max_boxes=100, method=method,
                                     use_iol=use_iol)
    torch.cuda.synchronize()
    assert cuda_nms.popmax_nms.launches == before + 1
    for g, w in zip(got, want):       # tail slots included
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize('army', [False, True])
@pytest.mark.parametrize('k', [64, 65, 1024, 7581])
def test_greedy_kernel_matches_plain(cuda_device, k, army):
    rng = np.random.RandomState(5)
    boxes = np.concatenate([rng.rand(2, k, 2) * 600, rng.rand(2, k, 2) * 90
                            + 5], -1).astype(np.float32)
    if army:                           # one box across several chunks
        boxes[:, 1:k // 2] = boxes[:, :1]
    valid = rng.rand(2, k) > 0.05
    boxes, valid = (torch.from_numpy(a).to(cuda_device)
                    for a in (boxes, valid))
    before = cuda_nms.greedy_nms.launches
    got = cuda_nms.greedy_nms(boxes, valid, 0.45, 'diou', True)
    want = cuda_nms.greedy_nms_plain(boxes, valid, 0.45, 'diou', True)
    torch.cuda.synchronize()
    assert cuda_nms.greedy_nms.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_popmax_kernel_rejects_pool_above_capacity(cuda_device):
    with pytest.raises(ValueError, match='holds at most'):
        cuda_nms.popmax_nms(torch.zeros(1, 20000, 4, device=cuda_device),
                            torch.zeros(1, 20000, device=cuda_device),
                            torch.zeros(1, 20000, dtype=torch.int32,
                                        device=cuda_device), 0.1, 0.5)
