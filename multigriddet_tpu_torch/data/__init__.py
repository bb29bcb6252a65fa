"""Host data helpers of the port: annotations, host image loading, the
native loader and matcher bindings."""

from .annotations import (HostImageLoader, letterbox_image,
                          load_and_letterbox, load_annotation_lines,
                          parse_annotation_line)

__all__ = [
    'HostImageLoader', 'letterbox_image', 'load_and_letterbox',
    'load_annotation_lines', 'parse_annotation_line',
]
