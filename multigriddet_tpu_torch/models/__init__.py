"""Model zoo of the port: every preset of the JAX package, its backbones,
necks and heads, the registry and custom composition."""

from .darknet import CSPDarknet53, Darknet53, MobileDarknet
from .detector import (MultiGridDet, TinyBackbone, build_custom,
                       multigriddet_csp_darknet, multigriddet_darknet,
                       multigriddet_darknet_lite, multigriddet_darknet_panet,
                       multigriddet_darknet_spp, multigriddet_mobile,
                       multigriddet_resnet, multigriddet_tiny)
from .head import MultiGridHead, MultiGridLiteHead, PANetHead
from .layers import (ConvBN, PredictConv, SeparableConvBN, batch_norm,
                     leaky_relu, mish, spp, upsample2x)
from .neck import MultiGridFPN
from .porting import module_call_order, port_keras_weights
from .registry import (create_model, get_backbone, get_head, get_neck,
                       list_available_models, list_components,
                       register_backbone, register_head, register_model,
                       register_neck)
from .resnet import ResNet, ResNet50, ResNet101
from .weights import (flax_to_state_dict, load_flax_variables,
                      load_weights_flexible, msgpack_restore,
                      msgpack_serialize, random_flax_variables,
                      state_dict_to_flax)

__all__ = [
    'CSPDarknet53', 'ConvBN', 'Darknet53', 'MobileDarknet', 'MultiGridDet',
    'MultiGridFPN', 'MultiGridHead', 'MultiGridLiteHead', 'PANetHead',
    'PredictConv', 'ResNet', 'ResNet50', 'ResNet101', 'SeparableConvBN',
    'TinyBackbone', 'batch_norm', 'build_custom', 'create_model',
    'flax_to_state_dict', 'get_backbone', 'get_head', 'get_neck',
    'leaky_relu', 'list_available_models', 'list_components',
    'load_flax_variables', 'load_weights_flexible', 'mish',
    'module_call_order',
    'msgpack_restore', 'msgpack_serialize', 'multigriddet_csp_darknet',
    'multigriddet_darknet', 'multigriddet_darknet_lite',
    'multigriddet_darknet_panet', 'multigriddet_darknet_spp',
    'multigriddet_mobile', 'multigriddet_resnet', 'multigriddet_tiny',
    'port_keras_weights',
    'random_flax_variables', 'register_backbone', 'register_head',
    'register_model', 'register_neck', 'spp', 'state_dict_to_flax',
    'upsample2x',
]
