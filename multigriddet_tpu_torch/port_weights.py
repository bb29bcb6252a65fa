"""Port the reference's Keras ``.h5`` weights to a flax ``.msgpack``
checkpoint: ``python -m multigriddet_tpu_torch.port_weights``.

Usage::

    python -m multigriddet_tpu_torch.port_weights --h5 model5.h5 \\
        --model-config configs/models/multigriddet_darknet.yaml \\
        --out trained_models/model5.msgpack [--device cpu]

The flags of the repo's ``tools/port_keras_weights.py``, plus ``--device``
(``cuda`` by default; the dry forward that orders the model's layers runs
there).  The model is built from the config with flax's initializers,
``models/porting.py`` ``port_keras_weights`` loads the file into it, and
the weights are written as ``{'params', 'batch_stats'}`` in flax's msgpack
layout, which both packages read.  Needs h5py.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--h5', required=True)
    p.add_argument('--model-config',
                   default='configs/models/multigriddet_darknet.yaml')
    p.add_argument('--out', required=True)
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    args = p.parse_args(argv)

    from .config import build_model_from_config, load_config
    from .config.builder import init_flax_like
    from .device import resolve_device
    from .models import port_keras_weights, state_dict_to_flax
    from .training.checkpoint import save_params

    dev = resolve_device(args.device)
    config = load_config(args.model_config)
    model, spec = build_model_from_config(config)
    hw = tuple(spec['input_shape'][:2])
    init_flax_like(model.to(dev), seed=0)
    port_keras_weights(args.h5, model, input_hw=hw)
    params, stats = state_dict_to_flax(model.state_dict())
    save_params(args.out, {'params': params, 'batch_stats': stats})
    print(f'Wrote {args.out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
