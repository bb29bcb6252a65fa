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
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..ops import cuda_jpeg


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
