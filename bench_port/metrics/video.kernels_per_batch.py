"""Kernels launched a batch in the traced stretch (``torch.profiler``)."""


def read(run):
    tr = run['data'].get('trace')
    if not tr or not tr['kernels']:
        return None
    return tr['kernels'] / tr['units']
