"""Postprocess layer of the port: the host-side extras.

Decode and NMS run on the device inside the fused step
(``training.steps.make_infer_step``); this package holds Weighted Boxes
Fusion and the reference-API decoder facade, as
``multigriddet_tpu/postprocess`` does.
"""

from .decoder import MultiGridDecoder
from .wbf import weighted_boxes_fusion

__all__ = ['MultiGridDecoder', 'weighted_boxes_fusion']
