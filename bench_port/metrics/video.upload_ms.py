"""Host ms a batch of the traced stretch in the program's span
``infer.upload``: ``MultiGridInference.infer_batch``'s copy of the batch
to the card (``_to_device``: a pageable copy of the host's uint8
canvases).  From the program's span totals
(``harness/program_spans.host_ms``)."""

from bench_port.harness.program_spans import host_ms


def read(run):
    return host_ms(run, 'infer.upload')
