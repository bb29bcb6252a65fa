"""Spatial partitioning of the port (dp x sp): image rows banded over the
ranks of a space group (``parallel/spatial.py``), gloo on the CPU.

* **The primitive.**  ``gather_rows`` forward and backward against slicing
  the whole tensor, float64, exact: 2 and 3 ranks, uneven bands, pads of 0
  and -inf, halos wider than a neighbour's band, requests that skip a
  rank's band.
* **Every spatial block** at narrow width in float64 on two ranks over a
  canvas with uneven bands: ``ConvBN`` k1/k3 at stride 1 and 2,
  ``SeparableConvBN`` at stride 1 and 2, ``spp`` (also where the 13x13
  pool's halo passes the neighbour's band), ResNet's SAME convs, its
  bottleneck and its stem (7x7 conv + SAME max-pool), and upsample +
  concat: train-mode forward, input and parameter gradients and running
  statistics within 1e-10 of one process on the whole canvas.
* **``multigriddet_tiny`` at sp=2**, at 96x96 (its stride-32 map's 3
  rows band as 2 and 1, as 608's 19 rows band as 10 and 9) and 64x64,
  with the train config's loss (option 2, consensus on; also
  ``reference_compat`` with the ``grid`` normalizer): two SGD steps from
  the same weights, loss terms, running statistics and parameters within
  1e-10 of one process in float64 and 1e-5 in float32, dp2 x sp2 on four
  ranks in float64, and
  ``remat: full`` in float64 (the recompute repeats the row exchanges).
  The float32 sp=2 run is also held against the JAX step on
  ``make_mesh_2d(1, 2)`` of the 8-device CPU platform
  (``tests/conftest.py``): loss terms and running statistics within 1e-4
  relative.
* **The infer step under sp=2**: detections equal to one process's (the
  plain pop-max on the CPU).
* **A two-process ``MultiGridTrainer.train()``** with
  ``environment.spatial_partition: 2`` and augmentation on: equal losses
  on both ranks, within 1e-4 relative of one process's epoch losses.

The ranks are this file run as a script (no JAX imported there), each
with a timeout and a free port, so a hang fails the test instead of the
suite.  ``--noconftest -m cuda`` on the card runs two gloo ranks on CUDA
tensors.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from multigriddet_tpu_torch.losses import LossConfig  # noqa: E402
from multigriddet_tpu_torch.models import (create_model,  # noqa: E402
                                           load_flax_variables,
                                           random_flax_variables)
from multigriddet_tpu_torch.ops.encoding import encode_targets  # noqa: E402
from multigriddet_tpu_torch.parallel import (  # noqa: E402
    image_partition_spec, make_mesh_2d, shard_batch, spatial, world_size)
from multigriddet_tpu_torch.training import (TrainOptimizer,  # noqa: E402
                                             create_train_state,
                                             make_infer_step,
                                             make_train_step)

NC = 3
GLOBAL_BATCH = 4
LR = 1e-2
ANCHORS = [np.array([[40, 40], [30, 50], [50, 30]], np.float32),
           np.array([[20, 20], [14, 28], [28, 14]], np.float32),
           np.array([[10, 10], [7, 14], [14, 7]], np.float32)]
# the loss block of configs/train_config.yaml, with the per-positive
# normalizer on top of the batch one
LOSS = dict(coord_scale=5.0, no_object_scale=0.5, label_smoothing=0.01,
            use_consensus_loss=True, max_gt_boxes=16,
            loss_normalization=('batch', 'positives'))
TIMEOUT = 240


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _launch(mode, out_dir, *extra, world=2):
    """``world`` ranks of this file in ``mode``, each awaited with a
    timeout; returns their outputs."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get('PYTHONPATH', ''), OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(rank),
         str(world), str(port), str(out_dir), *map(str, extra)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f'rank failed:\n{out[-4000:]}'
    return outs


def _init(rank, world, port):
    torch.distributed.init_process_group(
        'gloo', init_method=f'tcp://localhost:{port}', world_size=world,
        rank=rank)


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) / scale if want.size else 0.0
    assert err <= rtol, f'{what}: {err:.3e} > {rtol}'


# ---------------------------------------------------------------------------
# (a) the primitive
# ---------------------------------------------------------------------------

def _gather_cases(sp):
    """(level rows, every rank's (lo, hi), pad value)."""
    cases = []
    for rows in (7, 11, 5):
        b = spatial.bands(rows, sp)
        for halo in (1, 2, 6):          # 6 passes a neighbour's band
            cases.append((rows, [(lo - halo, hi + halo) for lo, hi in b],
                          0.0))
            cases.append((rows, [(lo - halo, hi + halo) for lo, hi in b],
                          float('-inf')))
        # the whole level everywhere, and each rank asking for the band
        # of the rank after it (its own band skipped)
        cases.append((rows, [(0, rows)] * sp, 0.0))
        cases.append((rows, [b[(r + 1) % sp] for r in range(sp)], 0.0))
    # a request wholly outside the level, and one spanning all pads
    cases.append((4, [(-3, -1)] + [(0, 4)] * (sp - 1), 0.0))
    cases.append((3, [(-4, 7)] * sp, float('-inf')))
    return cases


def _worker_gather(rank, world, port, out_dir):
    _init(rank, world, port)
    space = spatial.SpaceGroup(world, rank)
    errs = []
    for i, (rows, spans, value) in enumerate(_gather_cases(world)):
        rng = np.random.RandomState(i)
        full = torch.from_numpy(rng.randn(2, 3, rows, 4))
        lo, hi = spatial.band(rows, world, rank)
        x = full[:, :, lo:hi].clone().requires_grad_(True)
        y = spatial.gather_rows(x, rows, [s[0] for s in spans],
                                [s[1] for s in spans], value, 2, space)
        # against the padded whole tensor, sliced
        top = max(0, -min(s[0] for s in spans))
        bottom = max(0, max(s[1] for s in spans) - rows)
        padded = torch.nn.functional.pad(full, (0, 0, top, bottom),
                                         value=value)
        r_lo, r_hi = spans[rank]
        want = padded[:, :, r_lo + top:r_hi + top]
        fwd = float((y - want).abs().nan_to_num(0.0).max())
        same_pads = bool(torch.equal(torch.isinf(y), torch.isinf(want)))
        # backward of sum_r <y_r, g_r>: each rank's g scattered into the
        # rows it asked for, summed, then this rank's band
        grads = [torch.from_numpy(np.random.RandomState(100 + 7 * i + r)
                                  .randn(2, 3, s[1] - s[0], 4))
                 for r, s in enumerate(spans)]
        y.backward(grads[rank])
        whole = torch.zeros(2, 3, rows + top + bottom, 4, dtype=torch.float64)
        for g, (s_lo, s_hi) in zip(grads, spans):
            whole[:, :, s_lo + top:s_hi + top] += g
        want_g = whole[:, :, top:top + rows][:, :, lo:hi]
        bwd = float((x.grad - want_g).abs().max())
        errs.append({'case': i, 'fwd': fwd, 'bwd': bwd, 'pads': same_pads})
    with open(os.path.join(out_dir, f'gather_{rank}.json'), 'w') as f:
        json.dump(errs, f)


@pytest.mark.parametrize('world', [2, 3])
def test_gather_rows_equals_slicing_the_whole_tensor(tmp_path, world):
    _launch('gather', tmp_path, world=world)
    for rank in range(world):
        errs = json.loads((tmp_path / f'gather_{rank}.json').read_text())
        assert len(errs) == len(_gather_cases(world))
        for e in errs:
            assert e['fwd'] == 0.0 and e['bwd'] == 0.0 and e['pads'], e


def test_band_map_and_level_table():
    # 19 rows (stride 32 of 608) over 2 ranks: 10 and 9
    assert spatial.bands(19, 2) == [(0, 10), (10, 19)]
    assert spatial.bands(13, 3) == [(0, 5), (5, 9), (9, 13)]
    part = spatial.Partition(spatial.SpaceGroup(2, 1), 608)
    for rows in (304, 152, 76, 38, 19):
        part.add(rows)
    assert part.rows(torch.zeros(1, 1, 9, 1)) == 19
    with pytest.raises(ValueError, match='at least one row'):
        spatial.Partition(spatial.SpaceGroup(4, 0), 64).add(2)
    with pytest.raises(ValueError, match='cannot tell'):
        spatial.Partition(spatial.SpaceGroup(2, 0), 12).add(11)
    with pytest.raises(ValueError, match='matches no level'):
        part.rows(torch.zeros(1, 1, 7, 1))


# ---------------------------------------------------------------------------
# (b) every spatial block, float64
# ---------------------------------------------------------------------------

BLOCK_ROWS, BLOCK_COLS = 19, 11


def _blocks():
    """name -> (a function making the module, input rows, channels, rows
    of the finer level of a second input or None)."""
    from multigriddet_tpu_torch.models import layers, resnet
    L = layers

    class SPP(torch.nn.Module):
        def forward(self, x, train=None):
            return L.spp(x)

    class UpCat(torch.nn.Module):
        """1x1 -> upsample -> concat with the finer tap -> 3x3."""

        def __init__(self):
            super().__init__()
            self.a = L.ConvBN(4, 3, 1, dtype=torch.float64)
            self.b = L.ConvBN(3 + 5, 4, 3, dtype=torch.float64)

        def forward(self, x, fine, train=None):
            y = torch.cat([L.upsample2x(self.a(x, train)), fine], 1)
            return self.b(y, train)

    class Stem(resnet.ResNet):
        def __init__(self):
            torch.nn.Module.__init__(self)
            self.dtype = torch.float64
            self.Conv_0 = torch.nn.Conv2d(3, 64, 7, 2, bias=False)
            self.BatchNorm_0 = torch.nn.BatchNorm2d(
                64, eps=resnet.RN_EPSILON, momentum=0.1)

        def forward(self, x, train=None):
            return self.stem(x, train)

    f64 = dict(dtype=torch.float64)
    return {
        'convbn_k1_s1': (lambda: L.ConvBN(4, 6, 1, **f64), 19, 4, None),
        'convbn_k3_s1': (lambda: L.ConvBN(4, 6, 3, **f64), 19, 4, None),
        'convbn_k3_s2': (lambda: L.ConvBN(4, 6, 3, 2, **f64), 19, 4, None),
        'convbn_k3_s2_even': (lambda: L.ConvBN(4, 6, 3, 2, **f64), 18, 4,
                              None),
        'separable_s1': (lambda: L.SeparableConvBN(4, 6, 3, **f64), 19, 4,
                         None),
        'separable_s2': (lambda: L.SeparableConvBN(4, 6, 3, 2, **f64), 19, 4,
                         None),
        'spp': (SPP, 19, 4, None),
        'spp_wide_halo': (SPP, 7, 4, None),
        'resnet_conv_k3_s2': (lambda: resnet._RNConvBN(4, 6, 3, 2, **f64),
                              19, 4, None),
        'resnet_conv_k1_s2': (lambda: resnet._RNConvBN(4, 6, 1, 2, **f64),
                              19, 4, None),
        'resnet_bottleneck_s2': (lambda: resnet._Bottleneck(8, 4, 2, **f64),
                                 18, 8, None),
        'resnet_stem': (Stem, 38, 3, None),
        'upsample_concat': (UpCat, 9, 4, 18),
    }


def _block_run(name, space=None):
    """The block's train-mode forward and backward of ``sum(out * G)`` on
    the whole canvas (``space`` None) or on this rank's band."""
    build, rows, ch, fine_rows = _blocks()[name]
    torch.manual_seed(3)
    block = build().double().train()
    with torch.no_grad():
        for p in block.parameters():
            p.add_(0.1 * torch.randn_like(p))
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, ch, rows, BLOCK_COLS))
    inputs = [x]
    if fine_rows:
        inputs.append(torch.from_numpy(rng.randn(2, 5, fine_rows,
                                                 2 * BLOCK_COLS)))
    ins = [spatial.band_of(t, space, 2).clone().requires_grad_(True)
           for t in inputs]
    ctx = spatial.partitioned(space, rows)
    with ctx:
        if fine_rows and space is not None:
            spatial.current().add(fine_rows)
        y = block(*ins, train=True)
        out_rows = spatial.rows_of(y)
        g = torch.from_numpy(np.random.RandomState(6).randn(
            y.shape[0], y.shape[1], out_rows, y.shape[3]))
        (y * spatial.band_of(g, space, 2)).sum().backward()
    grads = {n: p.grad.clone() for n, p in block.named_parameters()}
    if space is not None:
        for v in grads.values():
            torch.distributed.all_reduce(v)
    stats = {n: b.clone() for n, b in block.named_buffers()
             if 'running' in n}
    return y.detach(), [t.grad for t in ins], grads, stats


def _worker_blocks(rank, world, port, out_dir):
    _init(rank, world, port)
    space = spatial.SpaceGroup(world, rank)
    errs = {}
    for name in _blocks():
        y, gin, gp, st = _block_run(name, space)
        y1, gin1, gp1, st1 = _block_run(name)
        e = {'out': float((y - spatial.band_of(y1, space, 2)).abs().max()),
             'rows': [y.shape[2], y1.shape[2]]}
        e['in_grad'] = max(float((g - spatial.band_of(g1, space, 2))
                                 .abs().max()) for g, g1 in zip(gin, gin1))
        e['param_grad'] = max([float((gp[k] - gp1[k]).abs().max())
                               / max(1.0, float(gp1[k].abs().max()))
                               for k in gp1] or [0.0])
        e['stats'] = max([float((st[k] - st1[k]).abs().max())
                          for k in st1] or [0.0])
        errs[name] = e
    with open(os.path.join(out_dir, f'blocks_{rank}.json'), 'w') as f:
        json.dump(errs, f)


def test_spatial_blocks_equal_one_process_at_uneven_bands(tmp_path):
    _launch('blocks', tmp_path)
    for rank in range(2):
        errs = json.loads((tmp_path / f'blocks_{rank}.json').read_text())
        assert set(errs) == set(_blocks())
        for name, e in errs.items():
            for k in ('out', 'in_grad', 'param_grad', 'stats'):
                assert e[k] <= 1e-10, (name, k, e)
        # the bands are uneven where the canvas says so
        assert errs['convbn_k3_s2']['rows'] == [[5, 4][rank], 9]


# ---------------------------------------------------------------------------
# (c) multigriddet_tiny at sp=2 and dp2 x sp2
# ---------------------------------------------------------------------------

def _batch(step, hw):
    rng = np.random.RandomState(20 + step)
    boxes = np.zeros((GLOBAL_BATCH, 6, 5), np.float32)
    for b in range(GLOBAL_BATCH):
        for t in range(rng.randint(2, 6)):
            w, h = rng.uniform(6, 40), rng.uniform(6, 40)
            x, y = rng.uniform(0, hw[1] - w), rng.uniform(0, hw[0] - h)
            boxes[b, t] = [x, y, x + w, y + h, rng.randint(NC)]
    images = rng.randint(0, 256, (GLOBAL_BATCH, *hw, 3)).astype(
        np.float32) / 255.0
    return images, boxes


def _loss_cfg(compat):
    if compat:
        return LossConfig(**dict(LOSS, reference_compat=True,
                                 loss_normalization=('grid',)))
    return LossConfig(**LOSS)


def run_steps(dtype, hw, mesh=None, device='cpu', steps=2, compat=False,
              remat=None):
    """Two SGD steps of ``multigriddet_tiny`` (``remat``: its
    ``environment.remat``) on this rank's share of each global batch (all
    of it single-process).  Returns the per-step metrics and the final
    parameters and running statistics."""
    torch.manual_seed(0)
    model = create_model('multigriddet_tiny', num_classes=NC, dtype=dtype,
                         remat=remat)
    load_flax_variables(model, *random_flax_variables(model, seed=4))
    model = model.to(device=device, dtype=dtype).train()
    opt = TrainOptimizer(torch.optim.SGD(model.parameters(), lr=LR))
    state = create_train_state(model, opt)
    step = make_train_step(ANCHORS, NC, hw, _loss_cfg(compat), mesh=mesh)
    metrics = []
    for i in range(steps):
        images, boxes = _batch(i, hw)
        y_true = encode_targets(torch.from_numpy(boxes), ANCHORS, NC, hw)
        images = torch.from_numpy(images)
        if mesh is not None:
            # P('batch'): the rank's dp share at the whole canvas; the
            # step keeps its band of rows
            images, *y_true = shard_batch(mesh, images, *y_true)
        state, m = step(state, images.to(device, dtype),
                        [y.to(device, dtype) for y in y_true])
        metrics.append({k: float(v) for k, v in m.items()})
    final = {k: v.detach().cpu().double()
             for k, v in model.state_dict().items()
             if not k.endswith('num_batches_tracked')}
    return metrics, final


def _worker_steps(rank, world, port, out_dir, dtype, hw, device, variant):
    _init(rank, world, port)
    mesh = make_mesh_2d(world // 2, 2)
    assert mesh.shape == {'batch': world // 2, 'space': 2}
    metrics, final = run_steps(getattr(torch, dtype), (int(hw), int(hw)),
                               mesh, device, **_VARIANTS[variant])
    torch.save({'metrics': metrics, 'final': final},
               os.path.join(out_dir, f'rank{rank}.pt'))


_VARIANTS = {'plain': {}, 'compat': {'compat': True},
             'remat': {'remat': 'full'}}


def _ranks(tmp_path, dtype, hw, world=2, device='cpu', variant='plain'):
    _launch('steps', tmp_path, dtype, hw, device, variant, world=world)
    ranks = [torch.load(tmp_path / f'rank{r}.pt') for r in range(world)]
    # every rank holds the same replica and reports the global metrics
    for r in ranks[1:]:
        for k, v in ranks[0]['final'].items():
            assert torch.equal(v, r['final'][k]), k
        assert ranks[0]['metrics'] == r['metrics']
    return ranks[0]['metrics'], ranks[0]['final']


def _assert_runs_close(sp, single, rtol):
    (m_sp, f_sp), (m_one, f_one) = sp, single
    for a, b in zip(m_sp, m_one):
        assert set(a) == set(b)
        for k in b:
            _close(a[k], b[k], rtol, f'metric {k}')
    assert set(f_sp) == set(f_one)
    for k in f_one:
        _close(f_sp[k], f_one[k], rtol, k)


@pytest.mark.parametrize('dtype,rtol,hw,world,variant', [
    ('float64', 1e-10, 96, 2, 'plain'),
    ('float32', 1e-5, 96, 2, 'plain'),
    ('float64', 1e-10, 64, 2, 'plain'),
    ('float32', 1e-5, 64, 2, 'plain'),
    ('float64', 1e-10, 96, 2, 'compat'),
    ('float64', 1e-10, 64, 4, 'plain'),
    ('float64', 1e-10, 96, 2, 'remat')],
    ids=['f64-96', 'f32-96', 'f64-64', 'f32-64', 'f64-96-compat',
         'f64-64-dp2xsp2', 'f64-96-remat-full'])
def test_tiny_sp_equals_one_process_on_the_whole_canvas(
        tmp_path, dtype, rtol, hw, world, variant):
    sp = _ranks(tmp_path, dtype, hw, world, variant=variant)
    single = run_steps(getattr(torch, dtype), (hw, hw),
                       **_VARIANTS[variant])
    assert sp[0][0]['num_positives'] == single[0][0]['num_positives'] > 0
    assert sp[0][0]['consensus_obj'] > 0
    _assert_runs_close(sp, single, rtol)
    if (dtype, hw, variant) == ('float32', 96, 'plain'):
        _assert_close_to_jax_mesh_2d(sp, (hw, hw))


def _assert_close_to_jax_mesh_2d(sp, hw):
    """(d) The JAX step on ``make_mesh_2d(1, 2)`` from the same weights and
    global batches: loss terms and running statistics within 1e-4
    relative."""
    import jax
    import jax.numpy as jnp
    import optax
    from multigriddet_tpu.losses import LossConfig as JLossConfig
    from multigriddet_tpu.models import create_model as jax_create_model
    from multigriddet_tpu.ops.encoding import encode_targets as jax_encode
    from multigriddet_tpu.parallel import make_mesh_2d as jax_mesh_2d
    from multigriddet_tpu.training import state as jstate_mod
    from multigriddet_tpu.training import steps as jsteps
    from multigriddet_tpu_torch.models import flax_to_state_dict
    from jax.sharding import NamedSharding, PartitionSpec as P
    jmodel = jax_create_model('multigriddet_tiny', num_classes=NC)
    params, stats = random_flax_variables(
        create_model('multigriddet_tiny', num_classes=NC), seed=4)
    mesh = jax_mesh_2d(1, 2, jax.devices()[:2])
    tx = optax.sgd(LR)
    state = jstate_mod.create_train_state(params, stats, tx)
    state = jax.device_put(state, NamedSharding(mesh, P()))
    step = jsteps.make_train_step(jmodel, tx, ANCHORS, NC, hw,
                                  JLossConfig(**LOSS), mesh=mesh,
                                  donate=False)
    for i, want in enumerate(sp[0]):
        images, boxes = _batch(i, hw)
        y_true = [jax.device_put(np.asarray(y),
                                 NamedSharding(mesh, P('batch')))
                  for y in jax_encode(boxes, ANCHORS, NC, hw)]
        images = jax.device_put(jnp.asarray(images),
                                NamedSharding(mesh, P('batch', 'space')))
        state, m = step(state, images, y_true)
        for k in m:
            _close(want[k], float(m[k]), 1e-4, f'step {i} {k} vs JAX')
    jstats = flax_to_state_dict({}, jax.tree_util.tree_map(
        np.asarray, state.batch_stats))
    for k, v in jstats.items():
        _close(sp[1][k], v, 1e-4, f'{k} vs JAX')


# ---------------------------------------------------------------------------
# (e) the infer step under sp=2
# ---------------------------------------------------------------------------

INFER_HW = (96, 96)


def run_infer(mesh=None, device='cpu'):
    """Detections and head maps of the infer step (``pallas_fused``: the
    pop-max, plain on the CPU) on one seeded batch, float64 model."""
    from multigriddet_tpu_torch.training.steps import head_maps
    torch.manual_seed(0)
    model = create_model('multigriddet_tiny', num_classes=NC,
                         dtype=torch.float64)
    load_flax_variables(model, *random_flax_variables(model, seed=7))
    model = model.to(device=device, dtype=torch.float64).eval()
    images, _ = _batch(0, INFER_HW)
    images = torch.from_numpy(images).to(device, torch.float64)
    step = make_infer_step(model, ANCHORS, INFER_HW, confidence=0.05,
                           nms_backend='pallas_fused', mesh=mesh)
    with torch.no_grad():
        space = None if mesh is None else mesh.space
        maps = [m.cpu() for m in head_maps(model, images, space)]
    return [t.cpu() for t in step(images)], maps


def _worker_infer(rank, world, port, out_dir):
    _init(rank, world, port)
    dets, maps = run_infer(make_mesh_2d(1, world))
    torch.save({'dets': dets, 'maps': maps},
               os.path.join(out_dir, f'infer_{rank}.pt'))


def test_infer_step_under_sp_equals_one_process(tmp_path):
    _launch('infer', tmp_path)
    dets, maps = run_infer()
    assert int(dets[3].sum()) > 0
    for rank in range(2):
        got = torch.load(tmp_path / f'infer_{rank}.pt')
        for a, b in zip(got['maps'], maps):
            _close(a, b, 1e-12, 'head map')
        for a, b in zip(got['dets'], dets):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (f) the trainer on two ranks, spatial_partition: 2
# ---------------------------------------------------------------------------

def _dataset(root):
    from PIL import Image, ImageDraw
    rng = np.random.RandomState(0)
    lines = []
    for i in range(8):
        img = Image.fromarray(rng.randint(0, 255, (80, 96, 3)).astype('uint8'))
        d = ImageDraw.Draw(img)
        x1, y1 = rng.randint(5, 30), rng.randint(5, 25)
        x2, y2 = x1 + rng.randint(25, 50), y1 + rng.randint(25, 45)
        cls = i % 2
        d.rectangle([x1, y1, x2, y2],
                    fill=(250, 20, 20) if cls == 0 else (20, 250, 20))
        p = os.path.join(root, f'img_{i}.jpg')
        img.save(p)
        lines.append(f'{p} {x1},{y1},{x2},{y2},{cls}')
    with open(os.path.join(root, 'train.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    with open(os.path.join(root, 'classes.txt'), 'w') as f:
        f.write('red\ngreen\n')
    with open(os.path.join(root, 'anchors.txt'), 'w') as f:
        f.write('40,40\n20,20\n10,10\n')


def trainer_config(root, out):
    j = os.path.join
    return {
        'model': {'type': 'preset', 'preset': {
            'architecture': 'multigriddet_tiny', 'num_classes': 2,
            'input_shape': [96, 96, 3], 'anchors_path': j(root, 'anchors.txt'),
            'classes_path': j(root, 'classes.txt')}},
        'data': {'train_annotation': j(root, 'train.txt'),
                 'val_annotation': j(root, 'train.txt')},
        'data_loader': {'num_workers': 1},
        'training': {
            'batch_size': GLOBAL_BATCH, 'epochs': 2, 'transfer_epochs': 1,
            'freeze_level': 1, 'learning_rate': 1e-3, 'loss_option': 2,
            'bn_recalibrate': True, 'bn_recalibrate_batches': 2,
            'augmentation': {'enabled': True, 'mosaic_prob': 0.3,
                             'mixup_prob': 0.1, 'max_boxes_per_image': 10}},
        'optimizer': {'type': 'adam'},
        'lr_schedule': {'type': 'cosine_annealing', 'warmup_epochs': 1},
        'callbacks': {'checkpoint': {'save_dir': j(out, 'ckpt')}},
        'output': {'log_dir': j(out, 'logs'), 'model_dir': j(out, 'models')},
        'environment': {'spatial_partition': 2},
    }


def _history(trainer):
    return {'losses': [h['loss'] for h in trainer.history],
            'val_losses': [h['val_loss'] for h in trainer.history],
            'steps': [h['steps'] for h in trainer.history]}


def _worker_trainer(rank, world, port, out_dir, root):
    from multigriddet_tpu_torch.training import MultiGridTrainer
    config = trainer_config(root, out_dir)
    config['environment']['distributed'] = {
        'enabled': True, 'coordinator_address': f'localhost:{port}',
        'num_processes': world, 'process_id': rank}
    trainer = MultiGridTrainer(config, device='cpu')
    trainer.train()
    out = dict(_history(trainer), rank=rank, world=world_size(),
               mesh=trainer.mesh.shape,
               local_batch=trainer.train_gen.batch_size,
               train_lines=trainer.train_lines)
    with open(os.path.join(out_dir, f'result_{rank}.json'), 'w') as f:
        json.dump(out, f)


def test_two_process_trainer_with_spatial_partition(tmp_path, monkeypatch):
    from multigriddet_tpu_torch.training import MultiGridTrainer
    from multigriddet_tpu_torch.training import trainer as trainer_mod
    root = tmp_path / 'data'
    root.mkdir()
    _dataset(str(root))
    _launch('trainer', tmp_path, str(root))
    r0, r1 = [json.loads((tmp_path / f'result_{r}.json').read_text())
              for r in range(2)]
    assert r0['mesh'] == r1['mesh'] == {'batch': 1, 'space': 2}
    # a space group reads the same lines, the whole global batch
    assert r0['local_batch'] == r1['local_batch'] == GLOBAL_BATCH
    assert r0['train_lines'] == r1['train_lines']
    assert r0['losses'] == r1['losses']
    assert r0['val_losses'] == r1['val_losses']
    # one process on the whole canvas: the 1-D fallback mesh of one rank,
    # reading the lines in the ranks' seeded order
    load = trainer_mod.load_annotation_lines
    monkeypatch.setattr(trainer_mod, 'load_annotation_lines',
                        lambda path, shuffle=True, seed=None: load(
                            path, shuffle, 0 if shuffle else seed))
    one = MultiGridTrainer(trainer_config(str(root), str(tmp_path / 'one')),
                           device='cpu')
    one.train()
    assert one.mesh.shape == {'batch': 1}
    want = _history(one)
    assert r0['steps'] == want['steps']
    np.testing.assert_allclose(r0['losses'], want['losses'], rtol=1e-4)
    np.testing.assert_allclose(r0['val_losses'], want['val_losses'],
                               rtol=1e-4)


def test_single_process_mesh_2d_and_spec():
    mesh = make_mesh_2d(1, 1)
    assert mesh.shape == {'batch': 1, 'space': 1} and mesh.size == 1
    assert image_partition_spec(mesh) == ('batch', 'space')
    x = torch.arange(24.).reshape(2, 3, 4)
    assert torch.equal(shard_batch(mesh, x, spec=image_partition_spec(
        mesh))[0], x)
    with pytest.raises(ValueError, match='needs 4 ranks'):
        make_mesh_2d(2, 2)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_two_gloo_ranks_on_cuda_tensors(tmp_path):
    """On the card: two sp ranks on one GPU (gloo on CUDA tensors, TF32
    off), ``multigriddet_tiny`` @96 float32, within 1e-5 of one process
    on the whole canvas."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU; run with -m cuda on the card')
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sp = _ranks(tmp_path, 'float32', 96, device='cuda')
        single = run_steps(torch.float32, (96, 96), device='cuda')
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    _assert_runs_close(sp, single, 1e-5)


if __name__ == '__main__':
    mode, rank, world, port, out_dir, *rest = sys.argv[1:]
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    worker = {'gather': _worker_gather, 'blocks': _worker_blocks,
              'steps': _worker_steps, 'infer': _worker_infer,
              'trainer': _worker_trainer}[mode]
    worker(int(rank), int(world), int(port), out_dir, *rest)
    torch.distributed.destroy_process_group()
