"""Nearest-2x upsample followed by a 3x3 SAME conv: kernels K7 and K8
(counterpart of star_tpu/ops/upsample_conv.py and the upsample kernels of
star_tpu/ops/conv3x3.py).

On the upsampled grid every output pixel of phase (r, s) = (row % 2,
col % 2) reads a fixed 2x2 window of the small grid, so the conv is four
2x2 convs on the small grid whose weights K_rs are tap sums of the 3x3
weights (`phase_weights`, in fp32, rounded once to the input dtype):

  K7 `upsample_conv2x`: for a CUDA tensor whose widths the kernel takes
     (C % 64 == 0 and Cout % 128 == 0: every decoder upsample of the
     full-width VAE) the four phase convs, fp32 bias and the interleave run
     in csrc/upsample_conv_sm90.cu (wgmma + TMA; its launch arithmetic is
     `upsample_conv2x_launch_plan`). Other widths run the four phase convs
     as torch convolutions with fp32 accumulation (as the JAX package
     leaves them to XLA), each rounded once after the fp32 bias, and K8
     interleaves them.
  K8 `interleave2x2`: out[2i+r, 2j+s] = p_rs[i, j] plus the output
     statistics, csrc/interleave2x2.cu for a CUDA tensor.

A CPU tensor runs the plain versions: the phase convs and
`interleave2x2_plain` (stack + reshape + channel_stats). Neither kernel has
a backward: under grad, with an input that requires grad, their launchers
raise.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..utils.profiling import spanned
from . import _build
from .conv3x3 import (H100_SMS, K6_BN, K6_GROUP_BYTES, K6_SMEM, K6_T,
                      K6_THREADS, _stats_buffers, channel_stats)

UPSAMPLE_LAUNCHES = 0     # K7
INTERLEAVE_LAUNCHES = 0   # K8

# the 3x3 taps a (rows, or columns) that fold into tap p of phase r: even
# outputs read a = 0 at p = 0 and a = 1, 2 at p = 1; odd outputs a = 0, 1
# at p = 0 and a = 2 at p = 1
_FOLD = (((0,), (1, 2)), ((0, 1), (2,)))


# K7's tiles (csrc/upsample_conv_sm90.cu): K6's (ops/conv3x3.py) with the
# phase as a tile index: a 16x16 patch of the small grid, one phase and 128
# output channels a block; the 18x18 halo of each 64-channel chunk in
# wgmma's plain K-major core-matrix layout serves the four phases' taps
K7_T, K7_BN, K7_PHASES = K6_T, K6_BN, 4
K7_HALO = K7_T + 2


def k7_takes(c: int, cout: int) -> bool:
    """The widths the K7 kernel's tiles divide: whole 64-channel chunks and
    128-channel column tiles."""
    return c >= 64 and c % 64 == 0 and cout >= K7_BN and cout % K7_BN == 0


def upsample_conv2x_launch_plan(n: int, h: int, w: int, c: int, cout: int,
                                sms: int = H100_SMS) -> dict:
    """What K7 launches for x [n, h, w, c] and Cout output channels: the
    tensor map of x (eight 8-channel boxes of the 18x18 halo from
    (h0 - 1, w0 - 1), unswizzled: K6's), of the [Cout, 16, C] weights
    (row 4 * phase + tap, 128 rows of 64 channels a box, 128-byte swizzle)
    and one map of the output for each phase (r, s): out[:, 2i+r, 2j+s]
    as [n, h, w, Cout], `offset` elements into out, 64-channel boxes of 16
    rows x 8 columns, swizzled; the tiles (column tiles fastest, then the
    phase, patch columns, patch rows, images) and the persistent grid over
    them (one block an SM), the threads and shared memory (K6's); and the
    A-operand arithmetic of the wgmma descriptors: tap (p, q) of phase
    (r, s) reads halo cell (r + p, s + q), `tap_bytes[4 * phase + 2 p + q]`
    bytes into the halo, consumer group g `group_bytes[g]` further, `sbo`
    bytes between patch rows, `lbo` between the two 8-channel halves of a
    k-step, the second 64-row block `mblock` bytes on. Raises ValueError on
    what the kernel does not take."""
    if min(n, h, w) < 1:
        raise ValueError(f'K7: empty launch [{n},{h},{w},{c}]')
    if not k7_takes(c, cout):
        raise ValueError(f'K7 takes C % 64 == 0 and Cout % 128 == 0, got '
                         f'C={c} Cout={cout}')
    tiles = (cout // K7_BN, K7_PHASES, -(-w // K7_T), -(-h // K7_T), n)
    ntiles = math.prod(tiles)
    if ntiles > 2 ** 31 - 1:
        raise ValueError(f'K7: {ntiles} tiles')
    phase_map = dict(dims=(cout, w, h, n),
                     strides=(4 * cout, 8 * w * cout, 8 * h * w * cout),
                     box=(64, 8, K7_T, 1), swizzle=128)
    return dict(x=dict(dims=(c, w, h, n),
                       strides=(c * 2, w * c * 2, h * w * c * 2),
                       box=(8, K7_HALO, K7_HALO, 1), swizzle=0),
                w=dict(dims=(c, 16, cout), strides=(c * 2, 16 * c * 2),
                       box=(64, 1, K7_BN), swizzle=128),
                out=tuple(dict(phase_map, offset=(2 * w * r + s) * cout)
                          for r in (0, 1) for s in (0, 1)),
                tiles=tiles, grid=(min(ntiles, sms),), threads=K6_THREADS,
                smem=K6_SMEM, chunks=c // 64, lbo=K6_GROUP_BYTES,
                sbo=K7_HALO * 16, mblock=8 * K7_HALO * 16,
                tap_bytes=tuple(16 * (K7_HALO * (r + p) + s + q)
                                for r in (0, 1) for s in (0, 1)
                                for p in (0, 1) for q in (0, 1)),
                group_bytes=(0, 16 * 8))


def k7_plan_args(plan: dict) -> tuple:
    """What of the plan star_upsample_conv2x takes, as C arrays: the four
    phase maps' element offsets into out, their byte strides (j, i, n;
    the same for every phase) and the 16 tap offsets."""
    strides = {m['strides'] for m in plan['out']}
    if len(strides) != 1:
        raise ValueError(f'K7: phase maps with strides {strides}')
    return ((ctypes.c_longlong * 4)(*(m['offset'] for m in plan['out'])),
            (ctypes.c_longlong * 3)(*strides.pop()),
            (ctypes.c_int * 16)(*plan['tap_bytes']))


def _fold(w: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """The three taps of `w` along `dim` summed into phase r's two."""
    return torch.stack([sum(w.select(dim, a) for a in taps)
                        for taps in _FOLD[r]], dim)


def phase_weights(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, C, 3, 3] -> the phase tap sums K_rs [4, 2, 2, C, Cout]
    in fp32 (phase 2r+s, taps (p, q)): the JAX package's
    einsum('ap,bq,abio->pqio', M_r, M_s, w_hwio) as sums of slices, so that
    no constant goes from the host to the card (a copy that would wait for
    the card's queue to drain)."""
    w = weight.float().permute(2, 3, 1, 0)                # HWIO
    return torch.stack([_fold(_fold(w, r, 0), s, 1)
                        for r in (0, 1) for s in (0, 1)])


def interleave2x2_plain(p00, p01, p10, p11, want_stats=False):
    n, h, w, c = p00.shape
    t = torch.stack([torch.stack([p00, p01], dim=3),
                     torch.stack([p10, p11], dim=3)], dim=2)
    out = t.reshape(n, 2 * h, 2 * w, c)
    return (out, channel_stats(out)) if want_stats else out


@spanned('kernel.K8')
def _launch_interleave(p00, p01, p10, p11, want_stats):
    global INTERLEAVE_LAUNCHES
    _build.refuse_grad('star_interleave2x2', p00, p01, p10, p11)
    n, h, w, c = p00.shape
    for p in (p00, p01, p10, p11):
        if not p.is_cuda or p.dtype != torch.bfloat16 \
                or not p.is_contiguous() or p.shape != p00.shape:
            raise ValueError('interleave kernel takes four contiguous bf16 '
                             'CUDA phases of one shape')
    if c % 8:
        raise ValueError(f'interleave kernel takes C % 8 == 0, got C={c}')
    out = torch.empty((n, 2 * h, 2 * w, c), dtype=p00.dtype,
                      device=p00.device)
    s, s2 = _stats_buffers(want_stats, n, c, out)
    err = _build.lib().star_interleave2x2(
        p00.data_ptr(), p01.data_ptr(), p10.data_ptr(), p11.data_ptr(),
        out.data_ptr(), s.data_ptr(), s2.data_ptr(), n, h, w, c,
        int(want_stats), _build.stream_ptr(p00.device))
    _build.check(err, 'star_interleave2x2')
    INTERLEAVE_LAUNCHES += 1
    return (out, (s, s2)) if want_stats else out


def interleave2x2(p00: torch.Tensor, p01: torch.Tensor, p10: torch.Tensor,
                  p11: torch.Tensor, want_stats: bool = False):
    """K8. p_rs [N, H, W, C] -> out [N, 2H, 2W, C] with
    out[:, 2i+r, 2j+s] = p_rs[:, i, j] (+ the per-(n, channel) fp32
    (sum, sumsq) of the output with want_stats)."""
    if p00.is_cuda:
        return _launch_interleave(p00, p01, p10, p11, want_stats)
    return interleave2x2_plain(p00, p01, p10, p11, want_stats)


def _phase_convs(x, k_rs, bias):
    """The four phase 2x2 convs on the zero-padded small grid, each
    round(conv with fp32 accumulation + fp32 bias) in x.dtype, with K_rs
    rounded to x.dtype as the kernel reads it."""
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).float().permute(0, 3, 1, 2)
    k = k_rs.to(x.dtype).float().permute(0, 4, 3, 1, 2)  # [4, O, I, 2, 2]
    b32 = bias.float()
    return [(F.conv2d(xp[:, :, r:r + h + 1, s:s + w + 1], k[2 * r + s])
             .permute(0, 2, 3, 1) + b32).to(x.dtype).contiguous()
            for r in (0, 1) for s in (0, 1)]


def upsample_conv2x_plain(x, k_rs, bias, want_stats=False):
    """K7's plain version: the phase convs and the plain interleave."""
    return interleave2x2_plain(*_phase_convs(x, k_rs, bias), want_stats)


def k7_weights(k_rs: torch.Tensor, device,
               dtype=torch.bfloat16) -> torch.Tensor:
    """K_rs [4, 2, 2, C, Cout] -> the kernel's K-major B operand [Cout, 16,
    C] (bf16 for the kernel), row 4 * phase + 2 p + q."""
    cout, c = k_rs.shape[-1], k_rs.shape[-2]
    return k_rs.to(device=device, dtype=dtype).permute(
        4, 0, 1, 2, 3).reshape(cout, 16, c).contiguous()


@spanned('kernel.K7')
def _launch_upsample(x, k_rs, bias, want_stats):
    """Launch csrc/upsample_conv_sm90.cu with the plan's phase maps, tap
    offsets and grid. The [Cout, 16, C] bf16 weight layout it reads is made
    here on every call."""
    global UPSAMPLE_LAUNCHES
    _build.refuse_grad('star_upsample_conv2x', x, k_rs, bias)
    n, h, w, c = x.shape
    cout = k_rs.shape[-1]
    if not x.is_cuda or x.dtype != torch.bfloat16 \
            or not x.is_contiguous():
        raise ValueError('upsample kernel takes a contiguous bf16 CUDA x, '
                         f'got {x.dtype} on {x.device}')
    if tuple(k_rs.shape) != (4, 2, 2, c, cout):
        raise ValueError(f'upsample kernel takes K_rs [4, 2, 2, C, Cout], '
                         f'got {tuple(k_rs.shape)} for C={c}')
    plan = upsample_conv2x_launch_plan(n, h, w, c, cout,
                                       sms=_build.sm_count(x.device))
    dev = x.device
    wk = k7_weights(k_rs, dev)
    bias32 = bias.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((n, 2 * h, 2 * w, cout), dtype=x.dtype, device=dev)
    s, s2 = _stats_buffers(want_stats, n, cout, out)
    err = _build.lib().star_upsample_conv2x(
        x.data_ptr(), wk.data_ptr(), bias32.data_ptr(), out.data_ptr(),
        s.data_ptr(), s2.data_ptr(), n, h, w, c, cout, int(want_stats),
        *k7_plan_args(plan), plan['grid'][0], _build.stream_ptr(dev))
    _build.check(err, 'star_upsample_conv2x')
    UPSAMPLE_LAUNCHES += 1
    return (out, (s, s2)) if want_stats else out


def upsample_conv2x(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, want_stats: bool = False):
    """K7. x [N, H, W, Cin], weight [Cout, Cin, 3, 3], bias [Cout]
    -> conv3x3(nearest_2x(x)) [N, 2H, 2W, Cout] in x.dtype (+ per-(n,
    channel) fp32 (sum, sumsq) of the output with want_stats)."""
    k_rs = phase_weights(weight)
    if x.is_cuda and k7_takes(x.shape[-1], k_rs.shape[-1]):
        return _launch_upsample(x, k_rs, bias, want_stats)
    return interleave2x2(*_phase_convs(x, k_rs, bias), want_stats=want_stats)


def upsample_conv2x_cropped(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """conv3x3(nearest_2x(x)[:, 1:-1], SAME): the I2VGen-XL UNet Upsample,
    which crops one row top and bottom before the conv (the inverse of the
    Downsample's asymmetric padding). x [N, H, W, Cin] ->
    [N, 2H-2, 2W, Cout]. Plain: the JAX package has no kernel for it."""
    up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0,
                       mode='nearest')[:, :, 1:-1]
    out = F.conv2d(up, weight.to(x.dtype), bias.to(x.dtype), 1, 1)
    return out.permute(0, 2, 3, 1)
