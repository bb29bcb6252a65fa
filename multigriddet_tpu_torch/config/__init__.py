"""Configuration loading and model factories of the port."""

from .builder import (build_model_for_inference, build_model_for_training,
                      build_model_from_config, class_weights_from_config,
                      create_optimizer_from_config, init_flax_like,
                      loss_config_from_config, make_lr_schedule,
                      model_spec_from_config, resolve_compute_dtype,
                      resolve_learning_rate, warmup_cosine_decay_schedule)
from .loader import (ConfigError, load_config, merge_configs, resolve_paths,
                     validate_config)

__all__ = [
    'ConfigError', 'build_model_for_inference', 'build_model_for_training',
    'build_model_from_config', 'class_weights_from_config',
    'create_optimizer_from_config', 'init_flax_like', 'load_config',
    'loss_config_from_config', 'make_lr_schedule', 'merge_configs',
    'model_spec_from_config', 'resolve_compute_dtype',
    'resolve_learning_rate', 'resolve_paths', 'validate_config',
    'warmup_cosine_decay_schedule',
]
