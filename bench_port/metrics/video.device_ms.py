"""Device ms of kernels a batch in the traced stretch (``torch.profiler``
kernel time, summed over kernels, over the batches traced)."""


def read(run):
    tr = run['data'].get('trace')
    if not tr or not tr['kernels']:
        return None
    return 1e3 * tr['kernel_s'] / tr['units']
