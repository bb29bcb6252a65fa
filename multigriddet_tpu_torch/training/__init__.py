"""Steps of the port; only the inference half is ported so far."""

from .steps import (candidate_pool, fetch_detections, make_infer_step,
                    unpack_detections)

__all__ = ['candidate_pool', 'fetch_detections', 'make_infer_step',
           'unpack_detections']
