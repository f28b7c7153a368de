"""Fused GroupNorm + SiLU + (3,1,1) temporal conv: kernel K5
(counterpart of star_tpu/ops/fused_temporal_conv.py).

GN apply from threaded (sum, sumsq) statistics, SiLU, the three frame taps
with fp32 accumulation, bias, optional residual, and the fp32 statistics of
the output for the next GN. `gn_coeffs` folds the statistics into (a, b) in
plain PyTorch; the rest is csrc/fused_tconv3_sm90.cu (wgmma + TMA; its
launch arithmetic is `tconv3_launch_plan`) for a CUDA tensor and the plain
version (the JAX package's `_tconv_xla`) for a CPU tensor.

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
gradient back to the stage that produced them. With bf16 operands the
plain version's tap product and its two gradients are bf16 GEMMs with fp32
accumulation (`_TapProduct`), as the JAX function's einsum of bf16
operands and its VJP are: on the card they run on the tensor cores.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..utils.profiling import spanned
from . import _build
from .conv3x3 import Stats, channel_stats, gn_coeffs

LAUNCHES = 0

# K5's tiles (csrc/fused_tconv3_sm90.cu): at most 128 rows a tile (two
# 64-row wgmma blocks), frame-major; two consumer warpgroups of NW columns
K5_BM = 128
K5_THREADS = 384      # a producer warpgroup and two consumers
K5_SLABS, K5_MAX_WSTAGES = 3, 6
# NW the kernel is built for, in the order of preference among widths that
# pad Cout alike: at 1280 channels 128 (a 3-stage weight ring) beat 160
# (2 stages), at 320 and 640 160 beat 80 (each element activated once;
# chip_variants.py measured 80 slower at every main-path shape)
K5_WIDTHS = (128, 160, 64, 32, 16)
SMEM_LIMIT = 232448
H100_SMS = 132


def tconv3_tiles(frames: int) -> tuple[int, int]:
    """(P, FT): P pixels (a multiple of 8, so a tap's shift of P rows is
    whole 1024-byte swizzle atoms) and FT frames a tile, FT*P <= 128: all
    frames when F < 16, else windows of 16 frames of 8 pixels."""
    if frames >= 16:
        return 8, 16
    return min(64, 8 * (16 // frames)), frames


def tconv3_width(cout: int) -> int:
    """NW: the fewest padded output columns over 2*NW-wide tiles, then the
    first in K5_WIDTHS (chip_variants.py k5 measured the order)."""
    return min(K5_WIDTHS, key=lambda nw: (-(-cout // (2 * nw)) * 2 * nw,
                                          K5_WIDTHS.index(nw)))


def _map4(d0, n, f, bsz, box, swizzle):
    """A 4-D TMA tensor map over [bsz, f, n, d0] bf16: dims and box
    innermost first, strides in bytes of dims 1-3."""
    return dict(dims=(d0, n, f, bsz),
                strides=(d0 * 2, n * d0 * 2, f * n * d0 * 2), box=box,
                swizzle=swizzle)


def tconv3_launch_plan(bsz: int, frames: int, n: int, c: int, cout: int,
                       nw: int | None = None, sms: int = H100_SMS) -> dict:
    """What K5 launches for x [bsz, frames, n, c] and Cout output channels:
    the tensor maps of x (slabs of FT + 2 frames from f0 - 1, 128-byte
    swizzle), of the K-major weights [3, Cout, C] (NW rows a box) and of the
    output and residual ([FT, P, BW] boxes, BW the widest of 64, 32, 16
    columns dividing NW, under the swizzle of 2 BW bytes); P, FT and NW; the
    slab's bytes (room for the 2P + 128 rows the third tap reads); the
    tiles (column tiles fastest, then pixel tiles, frame tiles, batch) and
    the persistent grid over them (one block an SM); the depth of the
    weight ring (as deep as shared memory allows, 2 to 6), the threads,
    the shared memory, the 64-channel chunks and the slab row at which
    each tap's A operand starts. Raises ValueError on what the kernel does
    not take."""
    if min(bsz, frames, n) < 1:
        raise ValueError(f'K5: empty launch [{bsz},{frames},{n},{c}]')
    if c < 8 or cout < 8 or c % 8 or cout % 8:
        raise ValueError(f'K5 takes C and Cout multiples of 8 (16-byte TMA '
                         f'rows), got C={c} Cout={cout}')
    p, ft = tconv3_tiles(frames)
    nw = tconv3_width(cout) if nw is None else nw
    if nw not in K5_WIDTHS:
        raise ValueError(f'K5 is built for NW in {K5_WIDTHS}, not {nw}')
    slab_bytes = (2 * p + K5_BM) * 128
    # the slab ring, two staging tiles of [128][NW], the barriers, and as
    # many weight stages of [2 NW][128 B] as fit
    fixed = 1024 + K5_SLABS * slab_bytes + 512 * nw + 256
    wstages = min(K5_MAX_WSTAGES, (SMEM_LIMIT - fixed) // (256 * nw))
    smem = fixed + wstages * 256 * nw
    tiles = (-(-cout // (2 * nw)), -(-n // p), -(-frames // ft), bsz)
    ntiles = tiles[0] * tiles[1] * tiles[2] * tiles[3]
    if wstages < 2 or ntiles > 2 ** 31 - 1:
        raise ValueError(f'K5: {wstages} weight stages, {ntiles} tiles')
    # output and residual in boxes of the staging's sub-tiles: bw columns
    # under the swizzle of their row width
    bw = 64 if nw % 64 == 0 else 32 if nw % 32 == 0 else 16
    out = _map4(cout, n, frames, bsz, (bw, p, ft, 1), 2 * bw)
    return dict(x=_map4(c, n, frames, bsz, (64, p, ft + 2, 1), 128),
                w=dict(dims=(c, cout, 3), strides=(c * 2, cout * c * 2),
                       box=(64, nw, 1), swizzle=128),
                out=out, res=out, p=p, ft=ft, nw=nw, bn=2 * nw,
                slab_bytes=slab_bytes, wstages=wstages, smem=smem,
                tiles=tiles, grid=(min(ntiles, sms),), threads=K5_THREADS,
                chunks=-(-c // 64),
                tap_rows=(0, p, 2 * p))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 matrices with fp32 accumulation and an fp32 result:
    one bf16 GEMM on the card's tensor cores; on the CPU (which has no
    kernel for `out_dtype`) the fp32 product of the upcast operands, whose
    values are the same up to the order of the sums."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


@contextlib.contextmanager
def _fp32_reductions():
    """cuBLAS may add the split-K partial sums of a bf16 GEMM in bf16
    unless told not to; fp32 accumulation is the contract, so this turns
    that off for the GEMMs inside and restores the process's setting."""
    mm = torch.backends.cuda.matmul
    prev = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_bf16_reduced_precision_reduction = prev


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 matrices with fp32 accumulation, rounded once to bf16:
    cuBLAS on the card (tensor cores), PyTorch's bf16 matmul on the CPU."""
    with _fp32_reductions():
        return torch.mm(a, b)


class _TapProduct(torch.autograd.Function):
    """The three taps' product ys [M, 3C] @ kb [3C, Cout] of bf16 operands
    with fp32 accumulation and an fp32 result, as the JAX function's
    einsum(..., preferred_element_type=f32) (`_tconv_xla`,
    star_tpu/ops/fused_temporal_conv.py:147-168). Its gradients are what
    JAX's VJP of that einsum computes: dys = ct @ kb^T and dkb = ys^T @ ct
    as bf16 GEMMs with fp32 accumulation, each rounded once to bf16. The
    cotangent ct is the gradient of the fp32 result through its one
    rounding to bf16 (plus the fp32 bias), so it holds bf16 values and is
    passed to the GEMM as bf16 without loss."""

    @staticmethod
    def forward(ctx, ys, kb):
        ctx.save_for_backward(ys, kb)
        return _mm_f32(ys, kb)

    @staticmethod
    def backward(ctx, ct):
        ys, kb = ctx.saved_tensors
        ct = ct.to(torch.bfloat16)
        dys = dkb = None
        if ctx.needs_input_grad[0]:
            dys = _mm_bf16(ct, kb.t())
        if ctx.needs_input_grad[1]:
            dkb = _mm_bf16(ys.t(), ct)
        return dys, dkb


def tconv3_plain(x, a, b, kernel3, bias, residual, want_stats,
                 per_frame=False):
    """x [B, F, N, C]; (a, b) [B, C] fp32; kernel3 [3, C, Cout]. Bulk apply
    and SiLU in x.dtype, taps accumulate in fp32 (bf16 operands through
    `_TapProduct`, fp32 ones in fp32), SAME padding over F."""
    bsz, f, n, c = x.shape
    cout = kernel3.shape[-1]
    y = x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]
    y = F.silu(y)
    kb = kernel3.reshape(3 * c, cout).to(x.dtype)
    yp = F.pad(y, (0, 0, 0, 0, 1, 1))
    ys = torch.cat([yp[:, tap:tap + f] for tap in range(3)], dim=-1)
    if x.dtype == torch.bfloat16:
        out = _TapProduct.apply(ys.reshape(-1, 3 * c), kb).reshape(
            bsz, f, n, cout)
    else:
        out = torch.matmul(ys.float(), kb.float())
    out = (out + bias.float()).to(x.dtype)
    if residual is not None:
        out = out + residual
    if want_stats:
        pool = (out.reshape(bsz * f, n, cout) if per_frame
                else out.reshape(bsz, f * n, cout))
        return out, channel_stats(pool)
    return out, None


@spanned('kernel.K5')
def _launch(x, a, b, kernel3, bias, residual, want_stats, per_frame):
    global LAUNCHES
    bsz, f, n, c = x.shape
    cout = kernel3.shape[-1]
    if not x.is_cuda or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError('fused tconv kernel takes a contiguous bf16 CUDA '
                         f'x, got {x.dtype} on {x.device}')
    plan = tconv3_launch_plan(bsz, f, n, c, cout,
                              sms=_build.sm_count(x.device))
    if residual is not None and (residual.shape != (bsz, f, n, cout)
                                 or residual.dtype != torch.bfloat16
                                 or not residual.is_contiguous()):
        raise ValueError('fused tconv kernel takes a contiguous bf16 '
                         'residual of the output shape')
    dev = x.device
    # K-major taps [3, Cout, C]: the B operand's rows under the swizzle
    w = kernel3.to(device=dev, dtype=torch.bfloat16).transpose(
        1, 2).contiguous()
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
        int(want_stats), int(per_frame), plan['p'], plan['ft'], plan['nw'],
        plan['slab_bytes'], plan['wstages'], plan['grid'][0], plan['smem'],
        _build.stream_ptr(dev))
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
