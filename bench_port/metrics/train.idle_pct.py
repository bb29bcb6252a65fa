"""Share of the traced train stretch's host-clock length in which no
kernel ran on the device (the union of kernel intervals is the busy
time)."""


def read(run):
    tr = run['data'].get('trace')
    if not tr or not tr['kernels'] or tr['wall_s'] <= 0:
        return None
    return 100.0 * (1.0 - tr['busy_s'] / tr['wall_s'])
