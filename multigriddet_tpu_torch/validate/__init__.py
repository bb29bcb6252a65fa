"""Learning validations of the port: counterparts of the JAX package's
``tools/validate_{learning,flagship,presets,anchor_prediction}.py``.

``python -m multigriddet_tpu_torch.validate {learning,flagship,presets,
anchors}`` writes the tool's synthetic set (``datasets``), trains on it
and scores the trained weights with the tool's own loop (``runner``).
"""

from .runner import (ANCHORS, FLAGSHIP, LEARNING, PRESETS, Run, Task,
                     Trained, run, score, scoring_batches, train, write_set)

__all__ = ['ANCHORS', 'FLAGSHIP', 'LEARNING', 'PRESETS', 'Run', 'Task',
           'Trained', 'run', 'score', 'scoring_batches', 'train',
           'write_set']
