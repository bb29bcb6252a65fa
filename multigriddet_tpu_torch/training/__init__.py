"""Training layer of the port: state, steps, checkpoints, trainer."""

from .calibrate import calibrate_batch_stats
from .checkpoint import (CheckpointManager, load_backbone_flexible,
                         load_params, load_weights_flexible, model_bundle,
                         save_params)
from .state import (TrainOptimizer, TrainState, apply_freeze, count_params,
                    create_train_state, freeze_labels)
from ..parallel.mesh import make_mesh, replicate, shard_batch
from .steps import (candidate_pool, fetch_detections, make_eval_step,
                    make_fused_train_step, make_infer_fn, make_infer_step,
                    make_train_step, unpack_detections)
from .trainer import MultiGridTrainer

__all__ = [
    'CheckpointManager', 'MultiGridTrainer', 'TrainOptimizer', 'TrainState',
    'apply_freeze', 'calibrate_batch_stats', 'candidate_pool',
    'count_params', 'create_train_state', 'fetch_detections',
    'freeze_labels', 'load_backbone_flexible', 'load_params',
    'load_weights_flexible', 'make_eval_step', 'make_fused_train_step',
    'make_infer_fn', 'make_infer_step', 'make_mesh', 'make_train_step',
    'model_bundle', 'replicate', 'save_params', 'shard_batch',
    'unpack_detections',
]
