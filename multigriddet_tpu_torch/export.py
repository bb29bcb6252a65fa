"""Export a model as a self-contained serving artifact:
``python -m multigriddet_tpu_torch.export``.

One ``torch.export`` program per batch size, the weights inside
(``inference/export.py``); ``ServingModel(path)`` serves it with torch and
numpy alone, on the torch version that wrote it.

Usage::

    python -m multigriddet_tpu_torch.export --config configs/infer_config.yaml \\
        --output serving/ [--batch-sizes 1,8,32] [--check] [--device cpu]

The flags of the repo's ``tools/export_serving.py``, plus ``--device``
(``cuda`` by default).  The model, its weights and the detection settings
come from the config as ``MultiGridInference`` reads them; the NMS runs
the portable ``xla`` backend whatever the config says.  ``--check``
reloads the artifact and holds its outputs on random canvases against the
live model: equal classes and valid masks, boxes and scores within 2e-5.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--config', required=True)
    ap.add_argument('--output', required=True)
    ap.add_argument('--batch-sizes', default='1,8')
    ap.add_argument('--check', action='store_true',
                    help='reload the artifact and compare vs the live model')
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    args = ap.parse_args(argv)

    from .config import load_config
    from .inference import MultiGridInference
    from .inference.export import ServingModel, export_serving
    from .training.steps import fetch_detections, make_infer_step

    config = load_config(args.config, config_type='infer')
    engine = MultiGridInference(config, device=args.device)
    batch_sizes = [int(b) for b in args.batch_sizes.split(',')]
    kw = dict(confidence=engine.confidence,
              nms_threshold=engine.nms_threshold,
              nms_method=engine.nms_method, use_iol=engine.use_iol,
              max_boxes=engine.max_boxes, pre_nms_top_k=engine.pre_nms_top_k,
              class_aware=engine.class_aware)
    meta = export_serving(engine.model, engine.spec['anchors'],
                          engine.input_hw, args.output,
                          batch_sizes=batch_sizes,
                          class_names=engine.class_names,
                          device=engine.device, **kw)
    sizes = {n: os.path.getsize(os.path.join(args.output, n)) / 2 ** 20
             for n in meta['programs'].values()}
    print(f'exported {args.output}: ' +
          ', '.join(f'{n} ({s:.1f} MB)' for n, s in sizes.items()))

    if args.check:
        import torch
        serving = ServingModel(args.output, device=engine.device)
        rng = np.random.RandomState(0)
        imgs = rng.randint(0, 255, (batch_sizes[0], *engine.input_hw, 3),
                           np.uint8)
        got = serving(imgs)
        live = make_infer_step(engine.model, engine.spec['anchors'],
                               engine.input_hw, **kw)
        want = fetch_detections(live(torch.from_numpy(imgs).to(
            engine.device)))
        for g, w, name in zip(got, want, meta['outputs']):
            if g.dtype.kind in 'biu':
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5,
                                           err_msg=name)
        print(f'check OK: artifact matches the live model on '
              f'{imgs.shape} (outputs: {", ".join(meta["outputs"])})')
    return 0


if __name__ == '__main__':
    sys.exit(main())
