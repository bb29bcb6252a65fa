"""Seeded photo-like frames and their letterboxed canvases, made on the
device in a few large calls.

A frame is a smooth field (random colours on a coarse grid, bicubic up
to the frame) with a handful of solid rectangles on it, so that it has
both the flat regions and the sharp edges of a photograph.  The boxes of
the rectangles are the frame's ground truth.  Every seed gives the same
sizes and counts; only the pixels and boxes differ.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

GRAY = 128


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    return g


def photo_frames(n: int, hw: Tuple[int, int], rects: int,
                 g: torch.Generator, device):
    """``n`` uint8 frames ``[n, H, W, 3]`` and their boxes ``[n, rects,
    5]`` (x1, y1, x2, y2, class in [0, 80)) as float32 pixels."""
    h, w = hw
    low = torch.rand(n, 3, 9, 12, generator=g, device=device) * 255
    field = F.interpolate(low, size=(h, w), mode='bicubic',
                          align_corners=False)
    u = torch.rand(n, rects, 7, generator=g, device=device)
    bw = (0.08 + 0.4 * u[..., 0]) * w
    bh = (0.08 + 0.4 * u[..., 1]) * h
    x1 = u[..., 2] * (w - bw)
    y1 = u[..., 3] * (h - bh)
    cls = torch.floor(u[..., 4] * 80)
    colour = torch.rand(n, rects, 3, generator=g, device=device) * 255
    ys = torch.arange(h, device=device, dtype=torch.float32)
    xs = torch.arange(w, device=device, dtype=torch.float32)
    img = field
    for r in range(rects):
        inside = (((ys[None, :, None] >= y1[:, r, None, None])
                   & (ys[None, :, None] < (y1 + bh)[:, r, None, None]))
                  & ((xs[None, None, :] >= x1[:, r, None, None])
                     & (xs[None, None, :] < (x1 + bw)[:, r, None, None])))
        img = torch.where(inside[:, None], colour[:, r, :, None, None], img)
    frames = img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    boxes = torch.stack([x1, y1, x1 + bw, y1 + bh, cls], dim=-1)
    return frames.contiguous(), boxes


def letterbox(frames: torch.Tensor, canvas_hw: Tuple[int, int]):
    """uint8 ``[n, h, w, 3]`` -> uint8 canvases ``[n, H, W, 3]``: scaled
    by ``min(H / h, W / w)`` (bilinear), centred on gray."""
    n, h, w, _ = frames.shape
    H, W = canvas_hw
    scale = min(H / h, W / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = F.interpolate(frames.permute(0, 3, 1, 2).float(), size=(nh, nw),
                      mode='bilinear', align_corners=False)
    top, left = (H - nh) // 2, (W - nw) // 2
    out = torch.full((n, 3, H, W), float(GRAY), device=frames.device)
    out[:, :, top:top + nh, left:left + nw] = x
    return out.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1) \
        .contiguous()
