"""Host data helpers and the input pipeline of the port: annotations, host
image loading, the native loader and matcher bindings, the generator."""

from .annotations import (HostImageLoader, letterbox_image,
                          load_and_letterbox, load_annotation_lines,
                          parse_annotation_line)
from .pipeline import MultiGridDataGenerator, calculate_expansion_factor

__all__ = [
    'HostImageLoader', 'MultiGridDataGenerator',
    'calculate_expansion_factor', 'letterbox_image', 'load_and_letterbox',
    'load_annotation_lines', 'parse_annotation_line',
]
