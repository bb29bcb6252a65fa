"""Host ms a step waits in ``next()`` on the generator's bank batches
(``MultiGridDataGenerator.iter_raw``: the producer thread's queue, the
bank's row gather arguments), from the benchmark's span over the
untraced window."""


def read(run):
    d = run['data']['spans'].get('bench.wait')
    return 1e3 * sum(d) / len(d) if d else None
