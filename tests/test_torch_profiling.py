"""The port's profiling utilities (``utils/profiling.py``).

``PhaseTimer`` keeps the JAX class's API and summary format (held
against ``multigriddet_tpu.utils.profiling.PhaseTimer`` on the same
totals); ``trace`` writes a Chrome trace of a ``torch.profiler`` capture
and is a no-op for ``None``; ``timed_op`` counts FLOPs with
``FlopCounterMode`` (a matmul is ``2 m n k``) and refuses a share of a
peak it does not know.  On the card (``-m cuda``), ``timed_op`` times with
CUDA events, ``null_wall`` is positive and the trace holds CUDA kernels.
JAX is imported inside the test that uses it, so the card collects this
file without it.
"""

import json
import time

import pytest
import torch

from multigriddet_tpu_torch.utils import profiling
from multigriddet_tpu_torch.utils.profiling import (PhaseTimer, count_flops,
                                                    null_wall, timed_op,
                                                    trace)


def test_phase_timer_api_and_summary_match_jax():
    from multigriddet_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer
    t = PhaseTimer()
    for _ in range(3):
        with t.phase('decode'):
            time.sleep(0.001)
    with t.phase('nms'):
        pass
    assert t.counts == {'decode': 3, 'nms': 1}
    assert t.totals['decode'] >= 0.003
    j = JaxPhaseTimer()
    j.totals, j.counts = dict(t.totals), dict(t.counts)
    assert t.summary() == j.summary()
    assert t.summary().splitlines()[0].startswith('decode')


def test_phase_timer_counts_a_phase_that_raises():
    t = PhaseTimer()
    with pytest.raises(KeyError):
        with t.phase('load'):
            raise KeyError('x')
    assert t.counts == {'load': 1}


def test_trace_is_a_no_op_without_a_directory(tmp_path):
    with trace(None) as prof:
        torch.ones(4).sum()
    assert prof is None
    with trace('') as prof:
        pass
    assert prof is None


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(32, 32)
    with trace(str(tmp_path / 'tr')) as prof:
        a @ a
    names = {e.name for e in prof.events()}
    assert 'aten::mm' in names
    events = json.loads((tmp_path / 'tr' / 'trace.json').read_text())
    assert any(e.get('name') == 'aten::mm'
               for e in events['traceEvents'])


def test_timed_op_and_flops_on_the_cpu():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    assert count_flops(torch.matmul, a, b) == 2 * 64 * 32 * 16
    dt = timed_op(torch.matmul, a, b, loop=4, repeats=2)
    assert 0 < dt < 1
    with pytest.raises(ValueError, match='peak_flops'):
        timed_op(torch.matmul, a, b, loop=2, repeats=1, with_mfu=True)
    dt, mfu = timed_op(torch.matmul, a, b, loop=4, repeats=2,
                       with_mfu=True, peak_flops=1e12)
    assert mfu == pytest.approx(2 * 64 * 32 * 16 / dt / 1e12)


def test_null_wall_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(profiling, '_NULL_WALL', {})
    with pytest.raises(RuntimeError, match='CUDA'):
        null_wall()


@pytest.mark.cuda
def test_timing_and_trace_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU; run with -m cuda on the card')
    a = torch.randn(1024, 1024, device='cuda', dtype=torch.bfloat16)
    floor = null_wall()
    dt, mfu = timed_op(torch.matmul, a, a, with_mfu=True)
    assert 0 < floor < dt < 1 and 0 < mfu < 1
    with trace(str(tmp_path)) as prof:
        a @ a
    assert any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())
