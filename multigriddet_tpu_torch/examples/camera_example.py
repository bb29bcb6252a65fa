"""Live camera detection example (counterpart of the repo's
``examples/camera_example.py``).  Press 'q' to quit.

    python -m multigriddet_tpu_torch.examples.camera_example [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    args = p.parse_args(argv)

    from ..config import load_config
    from ..inference import MultiGridInference

    config = load_config('configs/infer_config.yaml', config_type='infer')
    engine = MultiGridInference(config, device=args.device)
    cam_cfg = config.get('camera', {}) or {}
    engine.predict_camera(int(cam_cfg.get('device_id', 0)), show=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
