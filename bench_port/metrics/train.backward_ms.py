"""Host ms a step of the traced stretch in the program's span
``train.backward``: ``zero_grad`` and the backward.  From the program's
span totals (``harness/program_spans.host_ms``)."""

from bench_port.harness.program_spans import host_ms


def read(run):
    return host_ms(run, 'train.backward')
