"""The whole serve step's share of the card's bf16 dense peak: the
reference's forward FLOPs per image (``counts/<config>.json``) times the
images a second of the run's untraced window, over the peak
(``counts/h100.json``)."""


def read(run):
    flops = run['counts'][run['config']]['forward_flops_per_image']
    peak = run['counts']['h100']['bf16_dense_flops_per_s']
    rate = run['data'].get('img_per_s')
    if not rate:
        return None
    return 100.0 * flops * rate / peak
