"""Host ms a batch of the traced stretch in the program's span
``infer.fetch``: ``fetch_detections``: the reads of the result to the
host, which wait for the device.  From the program's span totals
(``harness/program_spans.host_ms``)."""

from bench_port.harness.program_spans import host_ms


def read(run):
    return host_ms(run, 'infer.fetch')
