"""Normalisation on channels-last tensors with fp32 statistics
(counterpart of star_tpu/ops/norms.py).

Statistics accumulate in float32 even under bf16 compute; the bulk apply
runs in the compute dtype with the subtract-first form
(x - mean) * a + b, exactly as the JAX package does.

`group_norm` (optionally with the SiLU after it) is kernel K13 on the card
(csrc/group_norm.cu: no kernel of the JAX package, where XLA fuses GroupNorm
and SiLU, star_tpu/models/unet/blocks.py:419-427): one statistics pass
(`star_gn_stats`, fp32 sums per channel folded into bf16 per-(n, channel)
mean, a and bias) and one apply (`star_gn_apply`, the SiLU fused), for a
contiguous 16-byte aligned bf16 CUDA tensor with C a multiple of 8 up to
8192; the launchers raise on any other CUDA tensor. On the CPU
`group_norm_plain` is the eager expression. Under autograd on a CUDA
tensor the forward is K13 and the backward recomputes the plain version
from the saved inputs and differentiates it.

The statistics the fused kernels thread from one GroupNorm to the next
live here too: `channel_stats` (K13's statistics pass alone on the card)
and `gn_coeffs`, which folds them into apply coefficients.

The models' LayerNorms run the kernels K10 and K11 (ops/fused_ln.py);
`gated_layer_norm` serves the SpatialLIEM-gated norm1, which no kernel
computes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import spanned
from . import _build, _contract

Stats = tuple[torch.Tensor, torch.Tensor]

_contract.kernels('group_norm', 'gn_stats')   # K13's applies, statistics

# K13's blocks (csrc/group_norm.cu): k row lanes of C / 8 threads, about
# GN_LANE_THREADS a block; C up to GN_MAX_C, groups of at most GN_MAX_GROUP
# channels
GN_LANE_THREADS = 256
GN_MAX_C = 8192
GN_MAX_GROUP = 1024


def _mean_f32(x: torch.Tensor, dims, keepdim=True) -> torch.Tensor:
    return torch.mean(x, dim=dims, keepdim=keepdim, dtype=torch.float32)


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, num_groups: int = 32,
                     eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """GroupNorm over the last (channel) axis; x [N, ..., C], statistics
    pooled over every axis but the first and per group of channels; with
    `silu`, the SiLU in fp32 rounded to x.dtype."""
    c = x.shape[-1]
    assert c % num_groups == 0, (c, num_groups)
    n = x.shape[0]
    dtype = x.dtype
    xg = x.reshape(n, -1, num_groups, c // num_groups)
    mean = _mean_f32(xg, (1, 3))                       # [N,1,G,1]
    mean2 = _mean_f32(xg.float().square(), (1, 3))
    inv = torch.rsqrt(mean2 - mean.square() + eps)
    a = inv * scale.float().reshape(num_groups, c // num_groups)
    bshape = (n,) + (1,) * (x.ndim - 2) + (c,)
    mean_b = mean.expand(n, 1, num_groups, c // num_groups).reshape(bshape)
    a = a.expand(n, 1, num_groups, c // num_groups).reshape(bshape)
    y = (x - mean_b.to(dtype)) * a.to(dtype) + bias.to(dtype)
    return F.silu(y.float()).to(y.dtype) if silu else y


def gn_launch_plan(c: int) -> dict:
    """K13's block for C channels: k row lanes of V = C / 8 threads (one
    16-byte vector each), about GN_LANE_THREADS threads in all."""
    nv = c // 8
    k = max(1, (GN_LANE_THREADS + nv // 2) // nv)
    return dict(k=k, threads=nv * k)


def kernel_takes(x: torch.Tensor, num_groups: int | None = None) -> bool:
    """Whether K13 takes x [N, ..., C]: its statistics alone, or with
    `num_groups` the GroupNorm."""
    c = x.shape[-1] if x.ndim else 0
    return (x.is_cuda and x.dtype == torch.bfloat16 and x.ndim >= 2
            and x.numel() > 0 and x.is_contiguous()
            and x.data_ptr() % 16 == 0 and c % 8 == 0 and c <= GN_MAX_C
            and x.shape[0] < 65536 and (
                num_groups is None or num_groups >= 1
                and c % num_groups == 0 and c // num_groups <= GN_MAX_GROUP))


def _check(x, num_groups=None, ndim=3):
    if (ndim is not None and x.ndim != ndim) or not kernel_takes(
            x, num_groups):
        raise ValueError(f'GroupNorm kernel takes a contiguous 16-byte '
                         f'aligned bf16 CUDA [N, R, C] with C a multiple of '
                         f'8 up to {GN_MAX_C} and groups of at most '
                         f'{GN_MAX_GROUP} channels, got {tuple(x.shape)} '
                         f'{x.dtype} on {x.device} in {num_groups} groups')


@spanned('kernel.K13')
def _launch_stats(x3, fold=None):
    """K13's statistics of x3 [N, R, C]: fp32 (sum, sum of squares)
    [N, C]; with fold = (scale, bias, num_groups, eps) the GroupNorm's bf16
    apply coefficients (mean, a, bias) [N, C] instead."""
    _check(x3)
    n, r, c = x3.shape
    dev = x3.device
    plan = gn_launch_plan(c)
    sms = _build.sm_count(dev)
    # the kernel's slabs an n: at most one wave of the blocks an SM holds
    max_slabs = max(1, min(r, sms * (2048 // plan['threads']) // n))
    part = torch.empty((n, max_slabs, 2, c), dtype=torch.float32,
                       device=dev)
    new = lambda dtype: torch.empty((n, c), dtype=dtype, device=dev)
    if fold is None:
        stats = (new(torch.float32), new(torch.float32))
        params, coeffs = (None, None, 0), (None, None, None)
        groups, eps = 1, 0.0
    else:
        scale, bias, groups, eps = fold
        if c % groups or c // groups > GN_MAX_GROUP:
            raise ValueError(f'GroupNorm kernel: {c} channels in {groups} '
                             f'groups')
        stats = (None, None)
        params = _params(scale, bias, dev)
        coeffs = tuple(new(torch.bfloat16) for _ in range(3))
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.lib().star_gn_stats(
        x3.data_ptr(), part.data_ptr(), *(ptr(t) for t in stats),
        ptr(params[0]), ptr(params[1]), params[2], *(ptr(t) for t in coeffs),
        n, r, c, groups, float(eps), plan['k'], max_slabs, sms,
        _build.stream_ptr(dev))
    _build.check(err, 'star_gn_stats')
    _contract.COUNTS['gn_stats'] += 1
    return stats if fold is None else coeffs


def _params(scale, bias, dev):
    """(scale, bias, 1) as bf16 where both are contiguous bf16 on the
    device, else (fp32 copies, 0): the kernel reads either, so a module's
    parameters need no cast."""
    if all(t.dtype == torch.bfloat16 and t.is_contiguous() and t.device == dev
           for t in (scale, bias)):
        return scale, bias, 1
    return (*(t.to(device=dev, dtype=torch.float32).contiguous()
              for t in (scale, bias)), 0)


@spanned('kernel.K13')
def _launch_apply(x3, mean, a, b, silu: bool):
    """K13's apply on x3 [N, R, C] with the bf16 coefficients [N, C]:
    bf16(bf16(bf16(x - mean) * a) + b), then the SiLU with `silu`."""
    _check(x3)
    n, r, c = x3.shape
    for t in (mean, a, b):
        if (t.shape != (n, c) or t.dtype != torch.bfloat16
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError('GroupNorm kernel takes contiguous bf16 '
                             f'coefficients [{n}, {c}]')
    dev = x3.device
    y = torch.empty_like(x3)
    err = _build.lib().star_gn_apply(
        x3.data_ptr(), mean.data_ptr(), a.data_ptr(), b.data_ptr(),
        y.data_ptr(), n, r, c, gn_launch_plan(c)['k'], int(bool(silu)),
        _build.sm_count(dev), _build.stream_ptr(dev))
    _build.check(err, 'star_gn_apply')
    _contract.COUNTS['group_norm'] += 1
    return y


def _k13(x, scale, bias, num_groups, eps, silu):
    _check(x, num_groups, ndim=None)
    n, c = x.shape[0], x.shape[-1]
    x3 = x.view(n, -1, c)
    mean, a, b = _launch_stats(x3, (scale, bias, num_groups, eps))
    return _launch_apply(x3, mean, a, b, silu).view(x.shape)


_K13 = _contract.Kernel(__name__, '_k13', 'group_norm_plain',
                        recompute=True)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm over the last (channel) axis (group_norm_plain's function),
    then the SiLU with `silu`: K13 for a CUDA tensor (raising on one it does
    not take), the plain version on the CPU. Differentiable (plain recompute
    backward)."""
    return _K13(x, scale, bias, num_groups, eps, silu)


def channel_stats(x: torch.Tensor) -> Stats:
    """Per-(leading, channel) fp32 (sum, sum of squares) over all middle
    axes: x [N, ..., C] -> ([N, C], [N, C]). K13's statistics pass for a
    CUDA tensor when no gradient is recorded (raising on one it does not
    take), else the plain sums: on the CPU, and in K5's recompute backward,
    which differentiates them on the card."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.reshape(n, -1, c)
    if xf.is_cuda and not _contract.needs_grad(xf):
        return _launch_stats(xf)
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


def gated_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm(g * x) for a per-token fp32 gate g [..., 1], folded into
    the LN coefficients so g*x is never materialised."""
    dtype = x.dtype
    mean = _mean_f32(x, (-1,))
    m2 = _mean_f32(x.float().square(), (-1,))
    g = g.float()
    var = torch.clamp(m2 - mean.square(), min=0.0)
    a = (g * torch.rsqrt(var * g.square() + eps)).to(dtype)
    return (x - mean.to(dtype)) * a * scale.to(dtype) + bias.to(dtype)
