"""Host ms a step of the traced stretch in the program's span
``train.loss``: MultiGridLoss (``multigrid_loss``).  From the program's
span totals (``harness/program_spans.host_ms``)."""

from bench_port.harness.program_spans import host_ms


def read(run):
    return host_ms(run, 'train.loss')
