"""JPEG files to letterboxed canvases on the card.

The card's counterpart of ``native.load_letterbox_batch`` /
``load_letterbox_yuv_batch`` (``native/fastloader.cpp``): as fastloader's
``nthreads`` native threads do, the calling thread and the threads of a
pool of ``num_workers`` (all but one of them) each take the next file of
the batch, read it on the host and decode it with nvJPEG to its YCbCr
planes (``cuda_jpeg.Decoder``, one each, its Huffman decode on the host:
the threads overlap them).  Then, on the calling thread and the
caller's current stream, the whole batch is converted to RGB in one
kernel launch and letterboxed in another (``ops/cuda_jpeg.py``).  A
worker's error (a fatal nvJPEG status, the card failing) is raised in the
caller.

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

The outputs do not depend on the pool: the slots come back in file
order, and each file's printed line is printed after the batch, in file
order.
"""

from __future__ import annotations

import io
import itertools
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, to_device
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


def libjpeg_planes(data: bytes):
    """A JPEG decoded by libjpeg through Pillow, the data ended by an EOI
    marker as libjpeg's source manager ends data that run out.

    Returns ``(planes, factors, (width, height))`` in host memory, as
    ``cuda_jpeg.Decoder.planes`` gives them: the three upsampled YCbCr
    planes at factors (1, 1), or a gray file's one plane and None; or None
    where Pillow does not import or cannot read the file."""
    if not pil_available():
        return None
    from PIL import Image
    try:
        with Image.open(io.BytesIO(data + EOI)) as im:
            size = im.size
            if im.mode == 'L':
                return (np.array(im),), None, size
            if im.mode != 'RGB':
                return None
            im.draft('YCbCr', size)
            ycc = np.asarray(im)
    except (OSError, ValueError):
        return None
    return (tuple(np.ascontiguousarray(ycc[..., c]) for c in range(3)),
            (1, 1), size)


class Decoded(NamedTuple):
    """One file as a worker leaves it: its planes (on the card, or in host
    memory from Pillow), their chroma factors (None: gray), the file's
    ``(width, height)``, and the line to print (None for a quiet decode);
    ``planes`` None for a slot that stays gray."""
    planes: Optional[tuple]
    factors: Optional[Tuple[int, int]]
    size: Optional[Tuple[int, int]]
    warning: Optional[str]


def _decode_one(dec, path: str, stream) -> Decoded:
    """Read and decode one file (a worker's step)."""
    try:
        with open(path, 'rb') as f:
            data = f.read()
    except OSError as exc:
        return Decoded(None, None, None, f'WARNING: cannot read {path} '
                       f'({exc.strerror}); a gray canvas')
    if truncated(data):
        got = libjpeg_planes(data)
        if got is None:
            return Decoded(None, None, None,
                           f'WARNING: {path} ends inside its scan '
                           f'(truncated) and Pillow does not import or read '
                           f'it; a gray canvas (nvJPEG would fill its '
                           f'missing part unlike libjpeg)')
        return Decoded(*got, f'WARNING: {path} ends inside its scan '
                       f'(truncated); decoded by libjpeg through Pillow, its '
                       f'missing blocks gray as fastloader decodes them')
    planes, factors, size, reason = dec.planes(data, stream)
    if planes is None:
        return Decoded(None, None, None,
                       f'WARNING: nvJPEG rejected {path} ({reason})')
    return Decoded(planes, factors, size, None)


def decode_files(paths: Sequence[str], device,
                 hw: Optional[Tuple[int, int]] = None,
                 pool: Optional[ThreadPoolExecutor] = None):
    """The decoded images of ``paths`` on ``device`` and their files'
    ``(width, height)`` (None for a file that could not be read or decoded,
    after one printed line).  With ``hw`` an image comes reduced by
    fastloader's divisor for that canvas.

    The calling thread decodes, joined by up to all but one of ``pool``'s
    threads (a loader's or an engine's, kept across batches; with none the
    calling thread decodes alone): as fastloader's ``nthreads`` threads
    do, each takes the next file until none is left, with a decoder of
    its own.  A file goes to whichever thread asks first, and a helper that
    has not started when the calling thread runs out of files is
    cancelled, so small files cost little more than on one thread.  The
    planes are handed to the caller's current stream, where one
    ``ycc_to_rgb_batch`` launch converts them all after the decodes end."""
    n = len(paths)
    if not n:
        return [], []
    device = resolve_device(device)
    stream = (torch.cuda.current_stream(device) if device.type == 'cuda'
              else None)
    results: List[Optional[Decoded]] = [None] * n
    order, lock = itertools.count(), threading.Lock()

    def take() -> int:
        with lock:
            return next(order)

    def work():
        i = take()
        if i >= n:
            return
        with cuda_jpeg.decoder(device) as dec:
            while i < n:
                results[i] = _decode_one(dec, paths[i], stream)
                i = take()

    helpers = [] if pool is None else [
        pool.submit(work) for _ in range(min(n, pool._max_workers) - 1)]
    try:
        work()
    finally:
        for f in helpers:     # not started: every file is taken
            f.cancel()
        wait(helpers)
    for f in helpers:
        if not f.cancelled():
            f.result()
    images: List[Optional[torch.Tensor]] = [None] * n
    sizes: List[Optional[Tuple[int, int]]] = [None] * n
    slots, where = [], []
    for i, got in enumerate(results):
        if got.warning:
            print(got.warning)
        if got.planes is None:
            continue
        planes = tuple(to_device(p, device) if isinstance(p, np.ndarray)
                       else p for p in got.planes)
        slots.append((planes, got.factors,
                      cuda_jpeg.divisor(*got.size, hw) if hw else 1))
        where.append(i)
        sizes[i] = got.size
    for i, image in zip(where, cuda_jpeg.ycc_to_rgb_batch(slots)):
        images[i] = image
    return images, sizes


def load_letterbox_batch_cuda(paths: Sequence[str], hw: Tuple[int, int],
                              device,
                              pool: Optional[ThreadPoolExecutor] = None):
    """Decode and letterbox JPEG files on the card, on the calling thread
    and ``pool``'s (:func:`decode_files`).

    Returns ``(images [N, th, tw, 3] u8 on device, metas [N, 5] f32,
    ok [N] bool)``; a failed slot is gray (128)."""
    device = torch.device(device)
    images, sizes = decode_files(paths, device, hw, pool)
    return cuda_jpeg.letterbox_rgb(images, hw, device, sizes)


def load_letterbox_yuv_batch_cuda(paths: Sequence[str], hw: Tuple[int, int],
                                  device,
                                  pool: Optional[ThreadPoolExecutor] = None):
    """Decode, letterbox and convert to planar 4:2:0 on the card, on the
    calling thread and ``pool``'s (:func:`decode_files`).

    Returns ``(y [N, th, tw], cb [N, th/2, tw/2], cr, metas, ok)``, the
    planes u8 on device; ``th`` and ``tw`` must be even."""
    device = torch.device(device)
    images, sizes = decode_files(paths, device, hw, pool)
    return cuda_jpeg.letterbox_yuv420(images, hw, device, sizes)
