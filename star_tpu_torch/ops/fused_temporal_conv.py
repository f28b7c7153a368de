"""Fused GroupNorm + SiLU + (3,1,1) temporal conv: kernel K5
(counterpart of star_tpu/ops/fused_temporal_conv.py).

GN apply from threaded (sum, sumsq) statistics, SiLU, the three frame taps
with fp32 accumulation, bias, optional residual, and the fp32 statistics of
the output for the next GN. `gn_coeffs` folds the statistics into (a, b) in
plain PyTorch; the rest is csrc/fused_tconv3.cu for a CUDA tensor and the
plain version (the JAX package's `_tconv_xla`) for a CPU tensor.

Under autograd the forward is the same, and the backward recomputes the
plain chain (statistics, `gn_coeffs`, `tconv3_plain`) from the saved
inputs and differentiates it, on CUDA tensors too, as the JAX package's
custom VJP recomputes through `_reference`
(`star_tpu/ops/fused_temporal_conv.py:256-263`); there is no backward
kernel, and this recompute is the one place (with K4's) where a plain
version runs on the card, by design. The threaded statistics are inputs
and outputs of the differentiated function: the backward takes
cotangents for the output (sum, sumsq) and returns them for the incoming
ones, which carry the mean and variance terms of the next GroupNorm's
gradient back to the stage that produced them.
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


def _coeffs(x, gn_scale, gn_bias, stats, num_groups, eps):
    """GN apply coefficients (a, b) [B, C] from the threaded statistics of
    x, or from x itself when there are none."""
    bsz, f, n, c = x.shape
    if stats is None:
        stats = channel_stats(x.reshape(bsz, f * n, c))
    return gn_coeffs(stats, f * n * (c // num_groups), gn_scale, gn_bias,
                     num_groups, eps)


def _stage(x, gn_scale, gn_bias, kernel, bias, stats, residual, num_groups,
           eps, want_stats, per_frame, plain=False):
    """One stage: K5 for a CUDA tensor unless `plain`, else the plain
    version (which the backward differentiates)."""
    a, b = _coeffs(x, gn_scale, gn_bias, stats, num_groups, eps)
    if x.is_cuda and not plain:
        return _launch(x, a, b, kernel[:, 0], bias, residual, want_stats,
                       per_frame)
    return tconv3_plain(x, a, b, kernel[:, 0], bias, residual, want_stats,
                        per_frame)


class _FusedTConv3(torch.autograd.Function):
    """K5 forward (the plain version on the CPU); the backward recomputes
    the plain stage from the saved inputs, the incoming statistics
    included, and differentiates it against the cotangents of y and of the
    output statistics."""

    @staticmethod
    def forward(ctx, x, gn_scale, gn_bias, kernel, bias, s_in, s2_in,
                residual, num_groups, eps, want_stats, per_frame):
        ctx.save_for_backward(x, gn_scale, gn_bias, kernel, bias, s_in,
                              s2_in, residual)
        ctx.cfg = (num_groups, eps, want_stats, per_frame)
        y, st = _stage(x, gn_scale, gn_bias, kernel, bias,
                       None if s_in is None else (s_in, s2_in), residual,
                       num_groups, eps, want_stats, per_frame)
        return (y, *st) if want_stats else y

    @staticmethod
    def backward(ctx, *cts):
        num_groups, eps, want_stats, per_frame = ctx.cfg
        inputs = [t.detach().requires_grad_() if t is not None and need
                  else t for t, need in zip(ctx.saved_tensors,
                                            ctx.needs_input_grad)]
        live = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            x, sc, bi, w, b, s, s2, r = inputs
            y, st = _stage(x, sc, bi, w, b, None if s is None else (s, s2),
                           r, num_groups, eps, want_stats, per_frame,
                           plain=True)
            grads = iter(torch.autograd.grad(
                [y, *st] if want_stats else [y], live, cts,
                allow_unused=True))
        return (*(next(grads) if t is not None and t.requires_grad else None
                  for t in inputs), None, None, None, None)


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
    [B*F, Cout]. Differentiable (plain recompute backward), through the
    threaded statistics too."""
    if _build.needs_grad(x, gn_scale, gn_bias, kernel, bias, residual,
                         *(stats or ())):
        s_in, s2_in = (None, None) if stats is None else stats
        out = _FusedTConv3.apply(x, gn_scale, gn_bias, kernel, bias, s_in,
                                 s2_in, residual, num_groups, eps,
                                 want_stats, stats_per_frame)
        return (out[0], tuple(out[1:])) if want_stats else (out, None)
    return _stage(x, gn_scale, gn_bias, kernel, bias, stats, residual,
                  num_groups, eps, want_stats, stats_per_frame)
