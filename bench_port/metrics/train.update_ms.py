"""Host ms a step of the traced stretch in the program's span
``train.update``: the optimizer update, the EMA update and the metrics
summed over the ranks.  From the program's span totals
(``harness/program_spans.host_ms``)."""

from bench_port.harness.program_spans import host_ms


def read(run):
    return host_ms(run, 'train.update')
