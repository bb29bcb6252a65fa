"""The pop-max NMS kernel's share of its roofline over the traced
stretch: the least time (pairs x ``ops_per_pair`` float32 operations at
the float32 peak; the kernel is bound by operations, its bytes are a few
MB) over the profiled time of the kernels named ``popmax``.  The pairs are
the reference greedy NMS's (kept box, live candidate) comparisons on the
traced batches' inputs."""


def read(run):
    tr = run['data'].get('trace')
    pairs = run['data'].get('popmax_pairs')
    if not tr or not pairs:
        return None
    t = sum(v for k, v in tr['by_name_s'].items() if 'popmax' in k)
    if t <= 0:
        return None
    ops = pairs * run['counts']['popmax_nms']['ops_per_pair']
    return 100.0 * ops / run['counts']['h100']['f32_flops_per_s'] / t
