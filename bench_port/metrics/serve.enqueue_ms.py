"""Host ms a batch spends in ``MultiGridInference.infer_batch`` (the
upload and the launch of the fused step; it returns before the device
is done), from the benchmark's span over the untraced window."""


def read(run):
    d = run['data']['spans'].get('bench.enqueue')
    return 1e3 * sum(d) / len(d) if d else None
