"""GroupNorm-apply + SiLU + 3x3 SAME conv with threaded statistics: kernel
K6 (counterpart of star_tpu/ops/conv3x3.py).

`fused_gn_silu_conv3x3` folds the GN statistics into per-(image, channel)
coefficients (a, b) in plain PyTorch, then computes
silu(x*a + b) -> 3x3 SAME conv (zero padding after the activation) with
fp32 accumulation + fp32 bias, one rounding to x.dtype, + residual, and the
fp32 statistics of the stored output. For a CUDA tensor whose C and Cout
are multiples of 128 — the shapes the JAX package's default configuration
sends to its Pallas kernels (the direct and H-Winograd forms; the 2-D
Winograd form computes the same function) — that is csrc/conv3x3_sm90.cu
(wgmma + TMA; its launch arithmetic is `conv3x3_launch_plan`); every
other shape, and every CPU tensor, runs the plain version `conv3x3_plain`,
as the JAX package leaves the other shapes to XLA. The kernel has no
backward (the VAE is never differentiated): under grad, with an input that
requires grad, its launcher raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import spanned
from . import _build

Stats = tuple[torch.Tensor, torch.Tensor]

LAUNCHES = 0

# K6's tiles (csrc/conv3x3_sm90.cu): a 16x16 output patch and 128 output
# channels a block; the 18x18 halo of each 64-channel chunk in wgmma's
# plain K-major core-matrix layout, [8 groups][328 pixels][8 channels]
K6_T, K6_BN = 16, 128
K6_HALO = K6_T + 2
K6_GROUP_BYTES = 328 * 16          # one 8-channel group of the halo
K6_THREADS = 384
# two halo stages, four weight stages, two staging tiles, the barriers
K6_SMEM = (1024 + 2 * 8 * K6_GROUP_BYTES + 4 * K6_BN * 128
           + 2 * 2 * 128 * 128 + 256)
H100_SMS = 132


def conv3x3_launch_plan(n: int, h: int, w: int, c: int, cout: int,
                        sms: int = H100_SMS) -> dict:
    """What K6 launches for x [n, h, w, c] and Cout output channels: the
    tensor maps of x (eight 8-channel boxes of the 18x18 halo from
    (h0 - 1, w0 - 1), unswizzled), of the [Cout, 3, 3, C] weights (128
    rows of 64 channels a box, 128-byte swizzle) and of the output and
    residual (64-channel boxes of 16 rows x 8 columns, swizzled); the
    tiles (column tiles fastest, then patch columns, patch rows, images)
    and the persistent grid over them (one block an SM), the threads and
    shared memory; and the A-operand arithmetic of the wgmma
    descriptors: tap (ty, tx) of consumer group g starts
    16 * (18 * ty + tx + 8 g) bytes into the halo, `sbo` bytes between
    patch rows, `lbo` between the two 8-channel halves of a k-step, the
    second 64-row block `mblock` bytes on. Raises ValueError on what the
    kernel does not take."""
    if min(n, h, w) < 1:
        raise ValueError(f'K6: empty launch [{n},{h},{w},{c}]')
    if c < 64 or c % 64 or cout < K6_BN or cout % K6_BN:
        raise ValueError(f'K6 takes C % 64 == 0 and Cout % 128 == 0, got '
                         f'C={c} Cout={cout}')
    tiles = (cout // K6_BN, -(-w // K6_T), -(-h // K6_T), n)
    ntiles = tiles[0] * tiles[1] * tiles[2] * tiles[3]
    if ntiles > 2 ** 31 - 1:
        raise ValueError(f'K6: {ntiles} tiles')
    out = dict(dims=(cout, w, h, n),
               strides=(cout * 2, w * cout * 2, h * w * cout * 2),
               box=(64, 8, K6_T, 1), swizzle=128)
    return dict(x=dict(dims=(c, w, h, n),
                       strides=(c * 2, w * c * 2, h * w * c * 2),
                       box=(8, K6_HALO, K6_HALO, 1), swizzle=0),
                w=dict(dims=(c, 9, cout), strides=(c * 2, 9 * c * 2),
                       box=(64, 1, K6_BN), swizzle=128),
                out=out, res=out, tiles=tiles, grid=(min(ntiles, sms),),
                threads=K6_THREADS, smem=K6_SMEM, chunks=c // 64,
                lbo=K6_GROUP_BYTES, sbo=K6_HALO * 16,
                mblock=8 * K6_HALO * 16,
                tap_bytes=tuple(16 * (K6_HALO * ty + tx) for ty in range(3)
                                for tx in range(3)),
                group_bytes=(0, 16 * 8))


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


@spanned('kernel.K6')
def _launch(x, a, b, weight, bias, residual, want_stats):
    """Launch csrc/conv3x3_sm90.cu. The [Cout, 3, 3, C] bf16 weight layout
    it reads (K contiguous) is made here on every call."""
    global LAUNCHES
    _build.refuse_grad('star_conv3x3', x, a, b, weight, bias, residual)
    n, h, w, c = x.shape
    cout = weight.shape[0]
    if not x.is_cuda or x.dtype != torch.bfloat16 \
            or not x.is_contiguous():
        raise ValueError('conv3x3 kernel takes a contiguous bf16 CUDA x, '
                         f'got {x.dtype} on {x.device}')
    if tuple(weight.shape) != (cout, c, 3, 3):
        raise ValueError(f'conv3x3 kernel takes a [Cout, C, 3, 3] weight, '
                         f'got {tuple(weight.shape)} for C={c}')
    plan = conv3x3_launch_plan(n, h, w, c, cout,
                               sms=_build.sm_count(x.device))
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
        int(want_stats), plan['grid'][0], _build.stream_ptr(dev))
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
