"""95th percentile, over every batch done in the untraced window, of
the time from when the batch was due (its in-flight slot freed) to its
detections on the host.  The loop runs at the card's capacity, where the
tail swings with the host's state from run to run, so it is a per-layer
reading beside the rate."""


def read(run):
    return run['data'].get('p95_ms')
