"""Nearest-2x upsample followed by a 3x3 SAME conv
(counterpart of star_tpu/ops/upsample_conv.py).

The JAX package computes these as four phase 2x2 convs (and, in its
default configuration, the Pallas kernels K7/K8); the function is
conv3x3(nearest_2x(x)), which is what the plain versions here spell out.
The kernels come in a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv3x3 import channel_stats


def _nearest2x_nchw(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0,
                         mode='nearest')


def upsample_conv2x(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, want_stats: bool = False):
    """x [N, H, W, Cin], weight [Cout, Cin, 3, 3], bias [Cout]
    -> [N, 2H, 2W, Cout] in x.dtype (+ per-(n, channel) fp32 (sum, sumsq)
    of the output with want_stats)."""
    up = _nearest2x_nchw(x)
    out = F.conv2d(up, weight.to(x.dtype), bias.to(x.dtype), 1, 1)
    out = out.permute(0, 2, 3, 1)
    return (out, channel_stats(out)) if want_stats else out


def upsample_conv2x_cropped(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """conv3x3(nearest_2x(x)[:, 1:-1], SAME): the I2VGen-XL UNet Upsample,
    which crops one row top and bottom before the conv (the inverse of the
    Downsample's asymmetric padding). x [N, H, W, Cin] ->
    [N, 2H-2, 2W, Cout]."""
    up = _nearest2x_nchw(x)[:, :, 1:-1]
    out = F.conv2d(up, weight.to(x.dtype), bias.to(x.dtype), 1, 1)
    return out.permute(0, 2, 3, 1)
