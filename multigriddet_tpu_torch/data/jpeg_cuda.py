"""JPEG files to letterboxed canvases on the card.

The card's counterpart of ``native.load_letterbox_batch`` /
``load_letterbox_yuv_batch`` (``native/fastloader.cpp``): each file is read
on the host, decoded by nvJPEG (``cuda_jpeg.Decoder``), and the whole
batch is letterboxed in one kernel launch on the caller's current stream
(``ops/cuda_jpeg.py``).
Same outputs as fastloader's functions, with the pixels on the device:
``metas [N, 5]`` f32 ``(scale, pad_x, pad_y, full_w, full_h)`` and
``ok [N]`` bool, numpy.  A file that cannot be read or that the decoder
rejects (not a JPEG, corrupt, CMYK) keeps fastloader's contract: a gray
canvas, zero metas, ``ok`` False, and one printed line naming the file and
the reason.  Any path may be given: nvJPEG rejects what is not a JPEG, and
retrying such a slot through PIL, where Pillow imports, is the caller's
choice.

A truncated file (its data end inside the last scan, with no EOI marker)
is one libjpeg reads: it warns, ends the data with an EOI marker and
decodes the missing blocks as zero coefficients, so they come out gray
and fastloader reports the file ``ok``.  nvJPEG accepts such a file too,
but fills the missing part with other pixels.  So a truncated file is
decoded by libjpeg through Pillow (the data ended by that EOI marker, the
upsampled YCbCr planes then converted and reduced on the card by
``ycc_to_rgb``), with one printed line naming that route.  Where Pillow
does not import or read it, the slot is rejected (gray, zero metas, ``ok``
False, one printed line): nvJPEG's pixels for the missing part are not
libjpeg's, so they are never returned as a decoded image.
"""

from __future__ import annotations

import io
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import to_device
from ..ops import cuda_jpeg
from .annotations import pil_available

EOI = b'\xff\xd9'
SOS = b'\xff\xda'


def truncated(data: bytes) -> bool:
    """Whether a JPEG's data end inside its last scan: a start-of-scan
    marker with no EOI marker after it (markers cannot occur inside the
    entropy-coded data, where a 0xFF byte is stuffed)."""
    sos = data.rfind(SOS)
    return sos >= 0 and data.find(EOI, sos) < 0


def decode_libjpeg(data: bytes, device, hw: Optional[Tuple[int, int]] = None):
    """Decode a JPEG with libjpeg through Pillow, the data ended by an EOI
    marker as libjpeg's source manager ends data that run out.

    Returns what ``cuda_jpeg.Decoder.decode`` returns for the file on
    ``device``: gray ``[H, W, 1]`` u8, or RGB reduced by fastloader's
    divisor for ``hw`` (libjpeg's upsampled YCbCr converted by
    ``ycc_to_rgb``), and ``(width, height)``; or None where Pillow does
    not import or cannot read the file."""
    if not pil_available():
        return None
    from PIL import Image
    try:
        with Image.open(io.BytesIO(data + EOI)) as im:
            size = im.size
            if im.mode == 'L':
                return to_device(np.array(im)[..., None], device), size
            if im.mode != 'RGB':
                return None
            im.draft('YCbCr', size)
            ycc = np.asarray(im)
    except (OSError, ValueError):
        return None
    planes = [to_device(np.ascontiguousarray(ycc[..., c]), device)
              for c in range(3)]
    d = cuda_jpeg.divisor(*size, hw) if hw else 1
    return cuda_jpeg.ycc_to_rgb(*planes, (1, 1), d), size


def decode_files(paths: Sequence[str], device,
                 hw: Optional[Tuple[int, int]] = None):
    """The decoded images of ``paths`` on ``device`` and their files'
    ``(width, height)`` (None for a file that could not be read or decoded,
    after one printed line).  With ``hw`` a colour image comes reduced by
    fastloader's divisor for that canvas (``Decoder.decode``)."""
    images: List[Optional[torch.Tensor]] = []
    sizes: List[Optional[Tuple[int, int]]] = []
    with cuda_jpeg.decoder(device) as dec:
        for path in paths:
            try:
                with open(path, 'rb') as f:
                    data = f.read()
            except OSError as exc:
                print(f'WARNING: cannot read {path} ({exc.strerror}); '
                      f'a gray canvas')
                images.append(None)
                sizes.append(None)
                continue
            if truncated(data):
                libjpeg = decode_libjpeg(data, device, hw)
                if libjpeg is None:
                    print(f'WARNING: {path} ends inside its scan '
                          f'(truncated) and Pillow does not import or read '
                          f'it; a gray canvas (nvJPEG would fill its '
                          f'missing part unlike libjpeg)')
                    libjpeg = (None, None)
                else:
                    print(f'WARNING: {path} ends inside its scan '
                          f'(truncated); decoded by libjpeg through Pillow, '
                          f'its missing blocks gray as fastloader decodes '
                          f'them')
                images.append(libjpeg[0])
                sizes.append(libjpeg[1])
                continue
            image, size, reason = dec.decode(data, hw)
            if image is None:
                print(f'WARNING: nvJPEG rejected {path} ({reason})')
            images.append(image)
            sizes.append(size)
    return images, sizes


def load_letterbox_batch_cuda(paths: Sequence[str], hw: Tuple[int, int],
                              device):
    """Decode and letterbox JPEG files on the card.

    Returns ``(images [N, th, tw, 3] u8 on device, metas [N, 5] f32,
    ok [N] bool)``; a failed slot is gray (128)."""
    device = torch.device(device)
    images, sizes = decode_files(paths, device, hw)
    return cuda_jpeg.letterbox_rgb(images, hw, device, sizes)


def load_letterbox_yuv_batch_cuda(paths: Sequence[str], hw: Tuple[int, int],
                                  device):
    """Decode, letterbox and convert to planar 4:2:0 on the card.

    Returns ``(y [N, th, tw], cb [N, th/2, tw/2], cr, metas, ok)``, the
    planes u8 on device; ``th`` and ``tw`` must be even."""
    device = torch.device(device)
    images, sizes = decode_files(paths, device, hw)
    return cuda_jpeg.letterbox_yuv420(images, hw, device, sizes)
