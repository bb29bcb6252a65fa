"""Serving entry points of the port: the engine and the exported
artifact."""

from .engine import MultiGridInference
from .export import ServingModel, export_serving

__all__ = ['MultiGridInference', 'ServingModel', 'export_serving']
