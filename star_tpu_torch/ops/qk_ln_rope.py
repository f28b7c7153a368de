"""Fused qk-LayerNorm + half-split RoPE: kernel K9
(counterpart of star_tpu/ops/qk_ln_rope.py), and its backward.

For every (row, head) of x [B, S, H*D]: LayerNorm over the head's D values
with fp32 statistics, the affine times `fold_scale` (the DiT folds the
attention softmax scale * log2(e) into q's), then the half-split rotation
y * cos + rotate_half(y) * sin with per-row tables; bf16 in, bf16 out.

The tables are [S, D]: every head shares its row, and text and pad rows
are the identity rotation (cos 1, sin 0). The JAX package passes the same
rows tiled across heads ([S, H*D]); the port never tiles them.

A CUDA tensor goes through csrc/qk_ln_rope.cu (D=64, bf16, contiguous;
anything else raises); a CPU tensor through the plain version, the JAX
package's `qk_ln_rope_reference`. Under grad the call is an autograd
Function: its forward is the kernel (the plain version on the CPU), its
backward the closed form of the gradient, recomputing the statistics from
the saved x: the backward kernel of csrc/qk_ln_rope.cu on a CUDA tensor,
`qk_ln_rope_bwd_plain` on the CPU. The JAX package defines no backward of
its own (jax.grad differentiates `qk_ln_rope_reference`), so the tests hold
the closed form to jax.grad. Gradients go to x, scale and bias; the cos/sin
tables take none. The forward launcher itself still refuses grad.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import annotate, spanned
from . import _build, _contract

LOG2E = 1.4426950408889634

_contract.kernels('qk_ln_rope', 'qk_ln_rope_bwd')
# calls of the autograd backward, on either device
BACKWARDS = 0

# csrc/qk_ln_rope.cu's backward: 64 (row, head) pairs a block, each block
# one [2, 64] fp32 partial of the bias and scale gradients
BWD_UNITS_PER_BLOCK = 64


def qk_ln_rope_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor, num_heads: int,
                     eps: float = 1e-6, fold_scale: float = 1.0
                     ) -> torch.Tensor:
    """x [B, S, H*D], scale/bias [D], cos/sin [S, D] -> [B, S, H*D] in
    x.dtype. Two-pass fp32 variance, as the kernel computes it."""
    b, s, c = x.shape
    d = c // num_heads
    x32 = x.float().reshape(b, s, num_heads, d)
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = (y * scale.float() + bias.float()) * fold_scale
    half = d // 2
    rot = torch.cat([-y[..., half:], y[..., :half]], dim=-1)
    out = y * cos.float()[None, :, None] + rot * sin.float()[None, :, None]
    return out.reshape(b, s, c).to(x.dtype)


def qk_ln_rope_bwd_plain(x: torch.Tensor, ct: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         cos: torch.Tensor, sin: torch.Tensor,
                         num_heads: int, eps: float = 1e-6,
                         fold_scale: float = 1.0, want_params: bool = True):
    """The backward kernel's plain version: the gradient of
    `qk_ln_rope_plain` for the output cotangent ct, in closed form, in
    fp32 (no autograd). Returns (dx in x.dtype, rounded once; dscale and
    dbias in their parameters' dtypes, or None without `want_params`)."""
    b, s, c = x.shape
    d = c // num_heads
    half = d // 2
    x32 = x.float().reshape(b, s, num_heads, d)
    ct32 = ct.float().reshape(b, s, num_heads, d)
    xc = x32 - x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    xh = xc * rstd
    # g = ct * cos + rot^T(ct * sin), rot^T(u) = (u[half:], -u[:half])
    u = ct32 * sin.float()[None, :, None]
    g = (ct32 * cos.float()[None, :, None]
         + torch.cat([u[..., half:], -u[..., :half]], dim=-1)) * fold_scale
    gh = g * scale.float()
    dx = rstd * (gh - gh.mean(-1, keepdim=True)
                 - xh * (gh * xh).mean(-1, keepdim=True))
    dx = dx.reshape(b, s, c).to(x.dtype)
    if not want_params:
        return dx, None, None
    return (dx, (g * xh).sum((0, 1, 2)).to(scale.dtype),
            g.sum((0, 1, 2)).to(bias.dtype))


def _check(x, others, scale, bias, cos, sin, num_heads, align):
    """Raises ValueError unless x and each of `others` are contiguous bf16
    CUDA tensors of x's shape, `align`-byte aligned, with head dim 64,
    [S, 64] tables and [64] scale and bias."""
    for t in (x, *others):
        if not t.is_cuda or t.dtype != torch.bfloat16 \
                or not t.is_contiguous() or t.shape != x.shape \
                or t.data_ptr() % align:
            raise ValueError(f'qk_ln_rope kernels take contiguous, '
                             f'{align}-byte aligned bf16 CUDA tensors of '
                             f'one shape, got {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}')
    b, s, c = x.shape
    if c != num_heads * 64:
        raise ValueError(f'qk_ln_rope kernels take head_dim 64, got {c} '
                         f'channels in {num_heads} heads')
    if tuple(cos.shape) != (s, 64) or tuple(sin.shape) != (s, 64) \
            or tuple(scale.shape) != (64,) or tuple(bias.shape) != (64,):
        raise ValueError(f'qk_ln_rope kernels take [S, 64] tables and [64] '
                         f'scale/bias, got {tuple(cos.shape)}, '
                         f'{tuple(scale.shape)}')


def _f32(t, dev):
    return t.to(device=dev, dtype=torch.float32).contiguous()


@spanned('kernel.K9')
def _launch(x, scale, bias, cos, sin, num_heads: int, eps: float,
            fold_scale: float):
    _contract.refuse_grad('star_qk_ln_rope', x, scale, bias)
    _check(x, (), scale, bias, cos, sin, num_heads, 4)
    b, s, _ = x.shape
    dev = x.device
    cos, sin = _f32(cos, dev), _f32(sin, dev)
    sc, bi = _f32(scale, dev) * fold_scale, _f32(bias, dev) * fold_scale
    out = torch.empty_like(x)
    err = _build.lib().star_qk_ln_rope(
        x.data_ptr(), cos.data_ptr(), sin.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), out.data_ptr(), b * s, s, num_heads, float(eps),
        _build.stream_ptr(dev))
    _build.check(err, 'star_qk_ln_rope')
    _contract.COUNTS['qk_ln_rope'] += 1
    return out


def _launch_bwd(x, ct, scale, bias, cos, sin, num_heads: int, eps: float,
                fold_scale: float, want_params: bool):
    """The backward kernel: (dx, dscale, dbias) as qk_ln_rope_bwd_plain
    gives them. One launch; with `want_params` its per-block partials are
    then summed over blocks (a fixed order: deterministic). Opens no range
    of its own: it runs directly inside the Function's
    `qk_ln_rope_backward`."""
    _check(x, (ct,), scale, bias, cos, sin, num_heads, 16)
    b, s, _ = x.shape
    dev = x.device
    cos, sin, sc = _f32(cos, dev), _f32(sin, dev), _f32(scale, dev)
    if any(t.data_ptr() % 16 for t in (cos, sin, sc)):
        raise ValueError('qk_ln_rope backward kernel takes 16-byte aligned '
                         'tables and scale')
    dx = torch.empty_like(x)
    blocks = -(-b * s * num_heads // BWD_UNITS_PER_BLOCK)
    part = torch.empty(blocks, 2, 64, device=dev, dtype=torch.float32) \
        if want_params else None
    err = _build.lib().star_qk_ln_rope_bwd(
        x.data_ptr(), ct.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        sc.data_ptr(), dx.data_ptr(), None if part is None else
        part.data_ptr(), b * s, s, num_heads, float(eps), float(fold_scale),
        _build.stream_ptr(dev))
    _build.check(err, 'star_qk_ln_rope_bwd')
    _contract.COUNTS['qk_ln_rope_bwd'] += 1
    if part is None:
        return dx, None, None
    dbias, dscale = part.sum(0)
    return dx, dscale.to(scale.dtype), dbias.to(bias.dtype)


_K9 = _contract.Kernel(__name__, '_launch', 'qk_ln_rope_plain')
_K9_BWD = _contract.Kernel(__name__, '_launch_bwd', 'qk_ln_rope_bwd_plain')


class _QkLnRope(torch.autograd.Function):
    """K9 forward (the plain version on the CPU); the backward is the
    closed form from the saved inputs (the backward kernel on the card)."""

    @staticmethod
    def forward(ctx, x, scale, bias, cos, sin, num_heads, eps, fold_scale):
        ctx.save_for_backward(x, scale, bias, cos, sin)
        ctx.args = (num_heads, eps, fold_scale)
        return _K9(x, scale, bias, cos, sin, num_heads, eps, fold_scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        global BACKWARDS
        BACKWARDS += 1
        x, scale, bias, cos, sin = ctx.saved_tensors
        need_x, need_sc, need_bi = ctx.needs_input_grad[:3]
        with annotate('qk_ln_rope_backward'):
            dx, dsc, dbi = _K9_BWD(x, ct.contiguous(), scale, bias, cos, sin,
                                   *ctx.args, need_sc or need_bi)
        return (dx if need_x else None, dsc if need_sc else None,
                dbi if need_bi else None, None, None, None, None, None)


def qk_ln_rope(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor, num_heads: int,
               eps: float = 1e-6, fold_scale: float = 1.0) -> torch.Tensor:
    """K9. x [B, S, H*D] -> LayerNormed and rotated [B, S, H*D].
    Differentiable in x, scale and bias (closed-form backward)."""
    if _contract.needs_grad(x, scale, bias):
        return _QkLnRope.apply(x, scale, bias, cos, sin, num_heads, eps,
                               fold_scale)
    return _K9(x, scale, bias, cos, sin, num_heads, eps, fold_scale)
