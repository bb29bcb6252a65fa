"""Configuration loading and model factories of the port."""

from .builder import (build_model_for_inference, build_model_from_config,
                      model_spec_from_config, resolve_compute_dtype)
from .loader import (ConfigError, load_config, merge_configs, resolve_paths,
                     validate_config)

__all__ = [
    'ConfigError', 'build_model_for_inference', 'build_model_from_config',
    'load_config', 'merge_configs', 'model_spec_from_config',
    'resolve_compute_dtype', 'resolve_paths', 'validate_config',
]
