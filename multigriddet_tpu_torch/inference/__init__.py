"""Serving entry point of the port."""

from .engine import MultiGridInference

__all__ = ['MultiGridInference']
