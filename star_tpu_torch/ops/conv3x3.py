"""GroupNorm-apply + SiLU + 3x3 SAME conv with threaded statistics: kernel
K6 (counterpart of star_tpu/ops/conv3x3.py).

`fused_gn_silu_conv3x3` folds the GN statistics into per-(image, channel)
coefficients (a, b) in plain PyTorch, then computes
silu(x*a + b) -> 3x3 SAME conv (zero padding after the activation) with
fp32 accumulation + fp32 bias, one rounding to x.dtype, + residual, and the
fp32 statistics of the stored output. For a CUDA tensor whose C and Cout
are multiples of 128 — the shapes the JAX package's default configuration
sends to its Pallas kernels (the direct and H-Winograd forms; the 2-D
Winograd form computes the same function) — that is csrc/conv3x3.cu; every
other shape, and every CPU tensor, runs the plain version `conv3x3_plain`,
as the JAX package leaves the other shapes to XLA. The kernel has no
backward (the VAE is never differentiated): under grad, with an input that
requires grad, its launcher raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

Stats = tuple[torch.Tensor, torch.Tensor]

LAUNCHES = 0


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


def conv3x3_plain(x, a, b, weight, bias, residual, want_stats):
    """The kernel's contract in plain PyTorch: x [N, H, W, C]; (a, b)
    [N, C] fp32; weight [Cout, C, 3, 3]. silu(x*a + b) in fp32 rounded once
    to x.dtype, zero SAME padding after the activation, the 9 taps with
    fp32 accumulation + fp32 bias, one rounding to x.dtype, + residual in
    x.dtype; statistics of the stored output in fp32."""
    y = F.silu(x.float() * a[:, None, None] + b[:, None, None]).to(x.dtype)
    acc = F.conv2d(y.float().permute(0, 3, 1, 2),
                   weight.to(x.dtype).float(), None, 1, 1)
    out = (acc.permute(0, 2, 3, 1) + bias.float()).to(x.dtype)
    if residual is not None:
        out = out + residual
    return out, (channel_stats(out) if want_stats else None)


def _stats_buffers(want_stats, n, c, out):
    """Zeroed fp32 (sum, sumsq) [n, c] for a kernel to add into, or a
    placeholder pointer it never writes without want_stats."""
    if not want_stats:
        return out, out
    return (torch.zeros((n, c), dtype=torch.float32, device=out.device),
            torch.zeros((n, c), dtype=torch.float32, device=out.device))


def _launch(x, a, b, weight, bias, residual, want_stats):
    """Launch csrc/conv3x3.cu. The [Cout, 3, 3, C] bf16 weight layout it
    reads (K contiguous) is made here on every call."""
    global LAUNCHES
    _build.refuse_grad('star_conv3x3', x, a, b, weight, bias, residual)
    n, h, w, c = x.shape
    cout = weight.shape[0]
    if not x.is_cuda or x.dtype != torch.bfloat16 \
            or not x.is_contiguous():
        raise ValueError('conv3x3 kernel takes a contiguous bf16 CUDA x, '
                         f'got {x.dtype} on {x.device}')
    if c % 32 or cout % 128 or tuple(weight.shape) != (cout, c, 3, 3):
        raise ValueError(f'conv3x3 kernel takes C % 32 == 0, Cout % 128 == '
                         f'0 and a [Cout, C, 3, 3] weight, got C={c} weight '
                         f'{tuple(weight.shape)}')
    if residual is not None and (residual.shape != (n, h, w, cout)
                                 or residual.dtype != torch.bfloat16
                                 or not residual.is_contiguous()):
        raise ValueError('conv3x3 kernel takes a contiguous bf16 residual of '
                         'the output shape')
    dev = x.device
    wk = weight.to(device=dev, dtype=torch.bfloat16).permute(
        0, 2, 3, 1).contiguous()
    a = a.to(device=dev, dtype=torch.float32).contiguous()
    b = b.to(device=dev, dtype=torch.float32).contiguous()
    bias32 = bias.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=dev)
    s, s2 = _stats_buffers(want_stats, n, cout, out)
    err = _build.lib().star_conv3x3(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), wk.data_ptr(),
        bias32.data_ptr(), None if residual is None else residual.data_ptr(),
        out.data_ptr(), s.data_ptr(), s2.data_ptr(), n, h, w, c, cout,
        int(want_stats), _build.stream_ptr(dev))
    _build.check(err, 'star_conv3x3')
    LAUNCHES += 1
    return out, ((s, s2) if want_stats else None)


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
    cout = weight.shape[0]
    if stats is None:
        stats = channel_stats(x)
    a, b = gn_coeffs(stats, h * w * (c // num_groups), gn_scale, gn_bias,
                     num_groups, eps)
    if x.is_cuda and c % 128 == 0 and cout % 128 == 0:
        return _launch(x, a, b, weight, bias, residual, want_stats)
    return conv3x3_plain(x, a, b, weight, bias, residual, want_stats)
