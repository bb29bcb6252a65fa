"""Host ms a batch of the traced stretch in the program's span
``infer.step``: ``MultiGridInference.infer_batch``'s call of the fused
step (forward, decode and NMS enqueued; it returns before the device is
done).  From the program's span totals
(``harness/program_spans.host_ms``)."""

from bench_port.harness.program_spans import host_ms


def read(run):
    return host_ms(run, 'infer.step')
