"""Fused GroupNorm + SiLU + (3,1,1) temporal conv: kernel K5
(counterpart of star_tpu/ops/fused_temporal_conv.py).

GN apply from threaded (sum, sumsq) statistics, SiLU, the three frame taps
with fp32 accumulation, bias, optional residual, and the fp32 statistics of
the output for the next GN. `gn_coeffs` folds the statistics into (a, b) in
plain PyTorch; the rest is csrc/fused_tconv3.cu for a CUDA tensor and the
plain version (the JAX package's `_tconv_xla`) for a CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .conv3x3 import Stats, channel_stats, gn_coeffs

LAUNCHES = 0


def tconv3_plain(x, a, b, kernel3, bias, residual, want_stats,
                 per_frame=False):
    """x [B, F, N, C]; (a, b) [B, C] fp32; kernel3 [3, C, Cout]. Bulk apply
    and SiLU in x.dtype, taps accumulate in fp32, SAME padding over F."""
    bsz, f, n, c = x.shape
    cout = kernel3.shape[-1]
    y = x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]
    y = F.silu(y)
    kb = kernel3.reshape(3 * c, cout).to(x.dtype)
    yp = F.pad(y, (0, 0, 0, 0, 1, 1))
    ys = torch.cat([yp[:, tap:tap + f] for tap in range(3)], dim=-1)
    out = torch.matmul(ys.float(), kb.float())
    out = (out + bias.float()).to(x.dtype)
    if residual is not None:
        out = out + residual
    if want_stats:
        pool = (out.reshape(bsz * f, n, cout) if per_frame
                else out.reshape(bsz, f * n, cout))
        return out, channel_stats(pool)
    return out, None


def _launch(x, a, b, kernel3, bias, residual, want_stats, per_frame):
    global LAUNCHES
    bsz, f, n, c = x.shape
    cout = kernel3.shape[-1]
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError('fused tconv kernel takes a contiguous bf16 x')
    if c % 32 or cout % 8:
        raise ValueError(f'fused tconv kernel takes C % 32 == 0 and '
                         f'Cout % 8 == 0, got C={c} Cout={cout}')
    if residual is not None and (residual.shape != (bsz, f, n, cout)
                                 or residual.dtype != torch.bfloat16
                                 or not residual.is_contiguous()):
        raise ValueError('fused tconv kernel takes a contiguous bf16 '
                         'residual of the output shape')
    dev = x.device
    w = kernel3.to(device=dev, dtype=torch.bfloat16).contiguous()
    a = a.to(device=dev, dtype=torch.float32).contiguous()
    b = b.to(device=dev, dtype=torch.float32).contiguous()
    bias32 = bias.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((bsz, f, n, cout), dtype=x.dtype, device=dev)
    rows = bsz * f if per_frame else bsz
    if want_stats:
        s = torch.zeros((rows, cout), dtype=torch.float32, device=dev)
        s2 = torch.zeros((rows, cout), dtype=torch.float32, device=dev)
    else:
        s = s2 = out      # never written without want_stats
    err = _build.lib().star_fused_gn_silu_tconv3(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
        bias32.data_ptr(), None if residual is None else residual.data_ptr(),
        out.data_ptr(), s.data_ptr(), s2.data_ptr(), bsz, f, n, c, cout,
        int(want_stats), int(per_frame), _build.stream_ptr(dev))
    _build.check(err, 'star_fused_gn_silu_tconv3')
    LAUNCHES += 1
    return out, ((s, s2) if want_stats else None)


def fused_gn_silu_tconv3(x: torch.Tensor, gn_scale: torch.Tensor,
                         gn_bias: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor, *, stats: Stats | None = None,
                         residual: torch.Tensor | None = None,
                         want_stats: bool = False, num_groups: int = 32,
                         eps: float = 1e-5, stats_per_frame: bool = False):
    """GroupNorm(x) -> SiLU -> (3,1,1) temporal conv (+bias) [+ residual].

    x [B, F, N, C]; kernel [3, 1, C, Cout] (the JAX nn.Conv((3,1)) layout,
    kept as is). GN statistics pool over (F, N, C/G) per batch element;
    `stats` is the fp32 (sum, sumsq) [B, C] of x, computed here when
    absent. Returns (y [B, F, N, Cout], stats_of_y | None); with
    `stats_per_frame` the output statistics are per (batch, frame) rows
    [B*F, Cout]."""
    bsz, f, n, c = x.shape
    if stats is None:
        stats = channel_stats(x.reshape(bsz, f * n, c))
    a, b = gn_coeffs(stats, f * n * (c // num_groups), gn_scale, gn_bias,
                     num_groups, eps)
    kernel3 = kernel[:, 0]
    if x.is_cuda:
        return _launch(x, a, b, kernel3, bias, residual, want_stats,
                       stats_per_frame)
    return tconv3_plain(x, a, b, kernel3, bias, residual, want_stats,
                        stats_per_frame)
