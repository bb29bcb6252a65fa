"""Frozen copy of ``multigriddet_tpu_torch/ops/yuv.py`` for the plain
reference (imports rewritten; nothing of the program is imported).

YCbCr 4:2:0 link transport: the host packs, the device unpacks.

Counterpart of ``multigriddet_tpu/ops/yuv.py``.  The host side box-averages
chroma 2x2 (:func:`rgb_to_yuv420_np`, the native loader's math); the
device side (:func:`yuv420_to_rgb`) upsamples chroma bilinearly with
half-pixel centres and inverts the BT.601 full-range matrix.
``F.interpolate(mode='bilinear', align_corners=False)`` at an exact 2x
scale gives the same weights as ``jax.image.resize(..., 'bilinear')``,
edges included: both put the whole weight on the edge sample there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# BT.601 full-range (JPEG JFIF) coefficients
_KR, _KG, _KB = 0.299, 0.587, 0.114


def rgb_to_yuv420_np(rgb: np.ndarray):
    """RGB u8 ``[..., H, W, 3]`` -> (y ``[..., H, W]``, cb, cr
    ``[..., H/2, W/2]``) u8; H and W must be even."""
    rgb = np.asarray(rgb)
    f = rgb.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = np.clip(_KR * r + _KG * g + _KB * b + 0.5, 0, 255).astype(np.uint8)
    h, w = rgb.shape[-3], rgb.shape[-2]
    q = f.reshape(*f.shape[:-3], h // 2, 2, w // 2, 2, 3).mean((-2, -4))
    rq, gq, bq = q[..., 0], q[..., 1], q[..., 2]
    cb = np.clip(128.0 - 0.168736 * rq - 0.331264 * gq + 0.5 * bq + 0.5,
                 0, 255).astype(np.uint8)
    cr = np.clip(128.0 + 0.5 * rq - 0.418688 * gq - 0.081312 * bq + 0.5,
                 0, 255).astype(np.uint8)
    return y, cb, cr


def _upsample_chroma(c: torch.Tensor, hw) -> torch.Tensor:
    lead = c.shape[:-2]
    flat = c.reshape(-1, 1, *c.shape[-2:])
    up = F.interpolate(flat, size=tuple(hw), mode='bilinear',
                       align_corners=False)
    return up.reshape(*lead, *hw)


def yuv420_to_rgb(y: torch.Tensor, cb: torch.Tensor,
                  cr: torch.Tensor) -> torch.Tensor:
    """Planar 4:2:0 u8 -> RGB float32 in [0, 255] ``[..., H, W, 3]``."""
    yf = y.float()
    hw = yf.shape[-2:]
    cbf = _upsample_chroma(cb.float() - 128.0, hw)
    crf = _upsample_chroma(cr.float() - 128.0, hw)
    r = yf + 1.402 * crf
    g = yf - (_KB / _KG) * 1.772 * cbf - (_KR / _KG) * 1.402 * crf
    b = yf + 1.772 * cbf
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)
