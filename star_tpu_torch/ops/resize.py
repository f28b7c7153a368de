"""Resize / padding helpers on channels-last tensors
(counterpart of star_tpu/ops/resize.py)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """x [..., H, W, C] -> [..., out_h, out_w, C]; bilinear with half-pixel
    centres (align_corners=False), antialiased on an axis that shrinks
    (the triangle widened by the ratio) — what jax.image.resize computes,
    for the pipeline's x4 upsample, for a target smaller than the input
    and for the degradation's 'area' mode. Computed in float64: PyTorch's antialiased path rounds its
    weights to about 1e-5 in float32 on an axis that grows."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    x4 = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x4.double(), size=(out_h, out_w), mode='bilinear',
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c).to(x.dtype)


def pad_to_fit(h: int, w: int,
               grid: tuple[int, int] = (720, 1280)
               ) -> tuple[int, int, int, int]:
    """Host-side padding (w1, w2, h1, h2) onto the 720x1280-or-64-multiple
    grid the UNet was trained on."""
    best_h, best_w = grid

    def _center(sz, best):
        a = (best - sz) // 2
        return a, best - a - sz

    if h < best_h:
        h1, h2 = _center(h, best_h)
    elif h == best_h:
        h1 = h2 = 0
    else:
        h1 = 0
        h2 = int((h + 48) // 64 * 64) + 64 - 48 - h
    if w < best_w:
        w1, w2 = _center(w, best_w)
    elif w == best_w:
        w1 = w2 = 0
    else:
        w1 = 0
        w2 = int(w // 64 * 64) + 64 - w
    return (w1, w2, h1, h2)


def adjust_resolution(h: int, w: int, up_scale: int) -> tuple[int, int]:
    """Target output resolution given the 720p floor / 1280*2048 area ceiling
    (inference_utils.py:42-54)."""
    if h * up_scale < 720:
        up_s = 720 / h
        return int(up_s * h // 2 * 2), int(up_s * w // 2 * 2)
    if h * w * up_scale * up_scale > 1280 * 2048:
        up_s = math.sqrt(1280 * 2048 / (h * w))
        return int(up_s * h // 2 * 2), int(up_s * w // 2 * 2)
    return int(up_scale * h // 2 * 2), int(up_scale * w // 2 * 2)
