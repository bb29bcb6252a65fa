"""YAML configuration loading, merging and path resolution.

Counterpart of ``multigriddet_tpu/config/loader.py``: a task YAML may name
a model YAML under ``model_config:``; the two are deep-merged, relative
path-like values are resolved against their file's directory, and the
task's required sections are checked.  PyYAML is imported when a file is
read, so configs given as dicts need no YAML package.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional

_PATH_SUFFIXES = ('.yaml', '.yml', '.txt', '.h5', '.msgpack', '.ckpt')

_REQUIRED_KEYS = {
    'train': ['data', 'training'],
    'infer': ['input', 'detection'],
    'eval': ['data', 'evaluation'],
}


class ConfigError(ValueError):
    pass


def merge_configs(base: Dict[str, Any],
                  override: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-merge ``override`` into ``base`` (override wins on leaves)."""
    out = copy.deepcopy(base)
    for key, val in override.items():
        if (key in out and isinstance(out[key], dict)
                and isinstance(val, dict)):
            out[key] = merge_configs(out[key], val)
        else:
            out[key] = copy.deepcopy(val)
    return out


def resolve_paths(config: Dict[str, Any], base_dir: str) -> Dict[str, Any]:
    """Make relative path-like string values absolute w.r.t. ``base_dir``."""
    def _resolve(value):
        if isinstance(value, dict):
            return {k: _resolve(v) for k, v in value.items()}
        if isinstance(value, list):
            return [_resolve(v) for v in value]
        if (isinstance(value, str) and value.endswith(_PATH_SUFFIXES)
                and not os.path.isabs(value)):
            return os.path.normpath(os.path.join(base_dir, value))
        return value
    return _resolve(config)


def validate_config(config: Dict[str, Any],
                    config_type: Optional[str] = None) -> None:
    """Check the task's required sections."""
    for key in _REQUIRED_KEYS.get(config_type or '', []):
        if key not in config:
            raise ConfigError(
                f'{config_type} config missing required section {key!r}')


def _read_yaml(path: str) -> Dict[str, Any]:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(path: str,
                config_type: Optional[str] = None) -> Dict[str, Any]:
    """Load a YAML config; follow and merge its ``model_config``."""
    config = _read_yaml(path)
    raw_model_cfg = config.get('model_config')
    base_dir = os.path.dirname(os.path.abspath(path))
    config = resolve_paths(config, base_dir)

    model_cfg_path = config.get('model_config')
    if model_cfg_path:
        # model_config is written repo-root-relative even inside configs/:
        # try the config's directory, then its parent, then the cwd
        candidates = [model_cfg_path if os.path.isabs(model_cfg_path)
                      else os.path.join(base_dir, model_cfg_path)]
        if raw_model_cfg and not os.path.isabs(raw_model_cfg):
            candidates.append(os.path.normpath(
                os.path.join(base_dir, os.pardir, raw_model_cfg)))
            candidates.append(os.path.normpath(
                os.path.join(os.getcwd(), raw_model_cfg)))
        model_cfg_path = next(
            (c for c in candidates if os.path.exists(c)), None)
        if model_cfg_path is None:
            print(f'WARNING: model_config {raw_model_cfg!r} resolved to no '
                  f'existing file (tried {candidates}); continuing without '
                  'the model preset merge.')
        else:
            model_cfg = resolve_paths(
                _read_yaml(model_cfg_path),
                os.path.dirname(os.path.abspath(model_cfg_path)))
            config = merge_configs(model_cfg, config)
    validate_config(config, config_type)
    return config
