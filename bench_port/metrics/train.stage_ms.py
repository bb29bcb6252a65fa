"""Host ms a step of the traced stretch in the program's span
``train.stage``: the fused bank step's device stage
(``_device_stage_bank``: bank gather, augmentation chain, /255, 9-cell
encoding).  From the program's span totals
(``harness/program_spans.host_ms``)."""

from bench_port.harness.program_spans import host_ms


def read(run):
    return host_ms(run, 'train.stage')
