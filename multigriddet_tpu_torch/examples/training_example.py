"""Python-API training example (counterpart of the repo's
``examples/training_example.py``): drive ``MultiGridTrainer`` directly
with an in-memory config.

    python -m multigriddet_tpu_torch.examples.training_example \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    args = p.parse_args(argv)

    from ..config import load_config
    from ..training import MultiGridTrainer

    config = load_config('configs/train_config.yaml', config_type='train')
    # tweak anything programmatically before training:
    config['training']['epochs'] = 3
    config['training']['batch_size'] = 8
    trainer = MultiGridTrainer(config, device=args.device)
    history = trainer.train()
    print('final train loss:', history[-1].get('loss'))
    return 0


if __name__ == '__main__':
    sys.exit(main())
