"""Host data helpers of the port (the inference side only)."""

from .annotations import letterbox_image

__all__ = ['letterbox_image']
