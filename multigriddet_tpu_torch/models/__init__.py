"""Model zoo of the port: the presets of the main path."""

from .darknet import Darknet53
from .detector import (MultiGridDet, TinyBackbone, create_model,
                       multigriddet_darknet, multigriddet_tiny)
from .head import MultiGridHead
from .layers import ConvBN, PredictConv, batch_norm, leaky_relu, upsample2x
from .weights import (flax_to_state_dict, load_flax_variables,
                      load_weights_flexible, msgpack_restore,
                      msgpack_serialize, random_flax_variables,
                      state_dict_to_flax)

__all__ = [
    'ConvBN', 'Darknet53', 'MultiGridDet', 'MultiGridHead', 'PredictConv',
    'TinyBackbone', 'batch_norm', 'create_model', 'flax_to_state_dict',
    'leaky_relu', 'load_flax_variables', 'load_weights_flexible',
    'msgpack_restore', 'msgpack_serialize', 'multigriddet_darknet',
    'multigriddet_tiny', 'random_flax_variables', 'state_dict_to_flax',
    'upsample2x',
]
