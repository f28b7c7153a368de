"""Nearest-2x upsample followed by a 3x3 SAME conv: kernels K7 and K8
(counterpart of star_tpu/ops/upsample_conv.py and the upsample kernels of
star_tpu/ops/conv3x3.py).

On the upsampled grid every output pixel of phase (r, s) = (row % 2,
col % 2) reads a fixed 2x2 window of the small grid, so the conv is four
2x2 convs on the small grid whose weights K_rs are tap sums of the 3x3
weights (`phase_weights`, in fp32, rounded once to the input dtype):

  K7 `upsample_conv2x`: for a CUDA tensor whose widths the kernel takes
     (C % 32 == 0 and Cout % 128 == 0: every decoder upsample of the
     full-width VAE) the four phase convs, fp32 bias and the interleave run
     in csrc/upsample_conv.cu. Other widths run the four phase convs as
     torch convolutions with fp32 accumulation (as the JAX package leaves
     them to XLA), each rounded once after the fp32 bias, and K8
     interleaves them.
  K8 `interleave2x2`: out[2i+r, 2j+s] = p_rs[i, j] plus the output
     statistics, csrc/interleave2x2.cu for a CUDA tensor.

A CPU tensor runs the plain versions: the phase convs and
`interleave2x2_plain` (stack + reshape + channel_stats). Neither kernel has
a backward: under grad, with an input that requires grad, their launchers
raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .conv3x3 import _stats_buffers, channel_stats

UPSAMPLE_LAUNCHES = 0     # K7
INTERLEAVE_LAUNCHES = 0   # K8

_M = (
    ((1.0, 0.0), (0.0, 1.0), (0.0, 1.0)),   # even outputs: a=0 -> p=0; a=1,2 -> p=1
    ((1.0, 0.0), (1.0, 0.0), (0.0, 1.0)),   # odd outputs:  a=0,1 -> p=0; a=2 -> p=1
)


def k7_takes(c: int, cout: int) -> bool:
    """The widths the K7 kernel's tiles divide."""
    return c % 32 == 0 and cout % 128 == 0


def phase_weights(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, C, 3, 3] -> the phase tap sums K_rs [4, 2, 2, C, Cout]
    in fp32 (phase 2r+s, taps (p, q)):
    K_rs = einsum('ap,bq,abio->pqio', M_r, M_s, w_hwio)."""
    w = weight.float().permute(2, 3, 1, 0)                # HWIO
    ms = [torch.tensor(m, dtype=torch.float32, device=weight.device)
          for m in _M]
    return torch.stack([torch.einsum('ap,bq,abio->pqio', ms[r], ms[s], w)
                        for r in (0, 1) for s in (0, 1)])


def interleave2x2_plain(p00, p01, p10, p11, want_stats=False):
    n, h, w, c = p00.shape
    t = torch.stack([torch.stack([p00, p01], dim=3),
                     torch.stack([p10, p11], dim=3)], dim=2)
    out = t.reshape(n, 2 * h, 2 * w, c)
    return (out, channel_stats(out)) if want_stats else out


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


def _launch_upsample(x, k_rs, bias, want_stats):
    """Launch csrc/upsample_conv.cu. The [4, Cout, 2, 2, C] bf16 weight
    layout it reads (K contiguous per phase) is made here on every call."""
    global UPSAMPLE_LAUNCHES
    _build.refuse_grad('star_upsample_conv2x', x, k_rs, bias)
    n, h, w, c = x.shape
    cout = k_rs.shape[-1]
    if not x.is_cuda or x.dtype != torch.bfloat16 \
            or not x.is_contiguous():
        raise ValueError('upsample kernel takes a contiguous bf16 CUDA x, '
                         f'got {x.dtype} on {x.device}')
    if not k7_takes(c, cout) or tuple(k_rs.shape) != (4, 2, 2, c, cout):
        raise ValueError(f'upsample kernel takes C % 32 == 0, Cout % 128 == '
                         f'0 and K_rs [4, 2, 2, C, Cout], got C={c} K_rs '
                         f'{tuple(k_rs.shape)}')
    dev = x.device
    wk = k_rs.to(device=dev, dtype=torch.bfloat16).permute(
        0, 4, 1, 2, 3).contiguous()
    bias32 = bias.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((n, 2 * h, 2 * w, cout), dtype=x.dtype, device=dev)
    s, s2 = _stats_buffers(want_stats, n, cout, out)
    err = _build.lib().star_upsample_conv2x(
        x.data_ptr(), wk.data_ptr(), bias32.data_ptr(), out.data_ptr(),
        s.data_ptr(), s2.data_ptr(), n, h, w, c, cout, int(want_stats),
        _build.stream_ptr(dev))
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
