"""GroupNorm-apply + SiLU + 3x3 SAME conv with threaded statistics
(counterpart of star_tpu/ops/conv3x3.py, its XLA route `_conv3x3_xla`).

This slice ports the configuration in which every VAE 3x3 conv runs the
plain route (the JAX package's STAR_TPU_DISABLE_CONV3X3=1 configuration,
and what it computes on the CPU). The Pallas kernels K6 (direct and
H-Winograd conv) are ported in a later slice; until then the conv itself is
torch's convolution, as the JAX route leaves it to XLA's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Stats = tuple[torch.Tensor, torch.Tensor]


def channel_stats(x: torch.Tensor) -> Stats:
    """Per-(leading, channel) fp32 (sum, sum of squares) over all middle
    axes: x [N, ..., C] -> ([N, C], [N, C])."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.reshape(n, -1, c)
    return (torch.sum(xf, dim=1, dtype=torch.float32),
            torch.sum(xf.float().square(), dim=1))


def gn_coeffs(stats: Stats, count: int, scale: torch.Tensor,
              bias: torch.Tensor, num_groups: int,
              eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold GN statistics (sum, sumsq) [N, C] accumulated over `count`
    elements per (n, group) into fp32 apply coefficients (a, b) [N, C] with
    GN(x) * scale + bias == x * a + b."""
    s, s2 = stats
    n, c = s.shape
    g = num_groups
    mean = s.reshape(n, g, c // g).sum(-1) / count
    var = s2.reshape(n, g, c // g).sum(-1) / count - mean.square()
    inv = torch.rsqrt(var + eps)                           # [N, G]
    inv_c = inv.repeat_interleave(c // g, dim=1)           # [N, C]
    mean_c = mean.repeat_interleave(c // g, dim=1)
    a = inv_c * scale.float()[None]
    b = bias.float()[None] - mean_c * a
    return a, b


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None = None, stride: int = 1,
                padding=0) -> torch.Tensor:
    """Conv2d on a channels-last [N, H, W, C] tensor with an OIHW weight.
    The NHWC -> NCHW permute is a view in channels_last memory format, so
    no copy is made on either side."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride, padding)
    return y.permute(0, 2, 3, 1)


def fused_gn_silu_conv3x3(x: torch.Tensor, gn_scale: torch.Tensor,
                          gn_bias: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, *, stats: Stats | None = None,
                          residual: torch.Tensor | None = None,
                          want_stats: bool = False, num_groups: int = 32,
                          eps: float = 1e-6):
    """GroupNorm(x) -> SiLU -> conv3x3 SAME (+bias) [+ residual].

    x [N, H, W, C]; weight [Cout, C, 3, 3]. Returns (y [N, H, W, Cout],
    stats_of_y | None), where stats_of_y is the per-(n, channel) fp32
    (sum, sumsq) of the output, to feed the next GN through `stats=`."""
    n, h, w, c = x.shape
    if stats is None:
        stats = channel_stats(x)
    a, b = gn_coeffs(stats, h * w * (c // num_groups), gn_scale, gn_bias,
                     num_groups, eps)
    # bulk apply and SiLU in x.dtype, then the conv; bias and residual
    # added in x.dtype
    y = F.silu(x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None])
    out = conv2d_nhwc(y, weight, None, 1, 1) + bias.to(x.dtype)
    if residual is not None:
        out = out + residual
    return out, (channel_stats(out) if want_stats else None)
