"""Serving-artifact example: export once, serve anywhere (counterpart of
the repo's ``examples/serving_example.py``).

Exports the configured model as a self-contained ``torch.export``
artifact (weights inside), then reloads it through the artifact alone
and runs a batch: the serving side needs torch and numpy, not the
package's models.

    python -m multigriddet_tpu_torch.examples.serving_example \\
        [image.jpg ...] [--device cpu]

An artifact serves on the torch version that wrote it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('images', nargs='*', default=['examples/images/dog.jpg'])
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    args = p.parse_args(argv)

    from PIL import Image

    out_dir = 'serving_artifact'
    if not os.path.exists(os.path.join(out_dir, 'metadata.json')):
        # --- export side (needs the package's models; run once) ---
        from ..config import load_config
        from ..inference import MultiGridInference, export_serving
        config = load_config('configs/infer_config.yaml',
                             config_type='infer')
        engine = MultiGridInference(config, device=args.device)
        # every configured postprocess knob, as the export CLI passes
        # them, so the artifact keeps the live engine's keep sets
        export_serving(engine.model, engine.spec['anchors'],
                       engine.input_hw, out_dir, batch_sizes=[1, 8],
                       class_names=engine.class_names, device=engine.device,
                       confidence=engine.confidence,
                       nms_threshold=engine.nms_threshold,
                       nms_method=engine.nms_method,
                       use_iol=engine.use_iol,
                       class_aware=engine.class_aware,
                       max_boxes=engine.max_boxes,
                       pre_nms_top_k=engine.pre_nms_top_k)
        print(f'exported -> {out_dir}/')

    # --- serving side (torch + numpy only) ---
    from ..data.annotations import letterbox_image
    from ..inference import ServingModel
    serving = ServingModel(out_dir, device=args.device)
    h, w = serving.input_hw
    canvases = []
    for path in args.images:
        with Image.open(path) as image:
            canvas, _, _, _ = letterbox_image(image.convert('RGB'), (h, w))
        canvases.append(canvas.astype(np.uint8))
    boxes, classes, scores, valid = serving(np.stack(canvases))
    for path, bx, cl, sc, va in zip(args.images, boxes, classes, scores,
                                    valid):
        print(path)
        for box, c, s in zip(bx[va], cl[va], sc[va]):
            name = (serving.class_names[int(c)]
                    if serving.class_names else str(int(c)))
            x, y, bw, bh = box
            print(f'  {name:>16} {s:.3f}  '
                  f'[{x:.0f}, {y:.0f}, {bw:.0f}x{bh:.0f}] (canvas px)')
    return 0


if __name__ == '__main__':
    sys.exit(main())
