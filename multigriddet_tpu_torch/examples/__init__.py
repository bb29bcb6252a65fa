"""Python-API examples of the port, counterparts of the repo's
``examples/*.py``: ``python -m multigriddet_tpu_torch.examples.<name>``
from the repo's root, with ``--device cpu`` where there is no card.

* ``inference_example [image]``: detect on one image with
  ``MultiGridInference`` from ``configs/infer_config.yaml``;
* ``serving_example [image ...]``: export once with ``export_serving``,
  then serve through the artifact alone with ``ServingModel``;
* ``training_example``: ``MultiGridTrainer`` from
  ``configs/train_config.yaml`` with the epochs and batch changed in code;
* ``camera_example``: the live camera loop (press 'q' to quit).
"""
