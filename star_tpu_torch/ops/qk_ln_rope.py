"""Fused qk-LayerNorm + half-split RoPE: kernel K9
(counterpart of star_tpu/ops/qk_ln_rope.py).

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
backward differentiates the plain version recomputed in fp32 from the saved
inputs, as jax.grad differentiates `qk_ln_rope_reference` (the JAX package
defines no backward of its own). Gradients go to x, scale and bias; the
cos/sin tables take none. The launcher itself still refuses grad.
"""

from __future__ import annotations

import torch

from . import _build
from .fused_ln import _recompute_grads

LOG2E = 1.4426950408889634

LAUNCHES = 0
# calls of the autograd backward (a plain recompute, not a kernel launch)
BACKWARDS = 0


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


def _launch(x, scale, bias, cos, sin, num_heads: int, eps: float,
            fold_scale: float):
    global LAUNCHES
    _build.refuse_grad('star_qk_ln_rope', x, scale, bias)
    if not x.is_cuda or x.dtype != torch.bfloat16 or not x.is_contiguous() \
            or x.data_ptr() % 4:
        raise ValueError('qk_ln_rope kernel takes a contiguous bf16 CUDA x, '
                         f'got {x.dtype} on {x.device}')
    b, s, c = x.shape
    if c != num_heads * 64:
        raise ValueError(f'qk_ln_rope kernel takes head_dim 64, got {c} '
                         f'channels in {num_heads} heads')
    if tuple(cos.shape) != (s, 64) or tuple(sin.shape) != (s, 64) \
            or tuple(scale.shape) != (64,) or tuple(bias.shape) != (64,):
        raise ValueError(f'qk_ln_rope kernel takes [S, 64] tables and [64] '
                         f'scale/bias, got {tuple(cos.shape)}, '
                         f'{tuple(scale.shape)}')
    dev = x.device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    cos, sin = f32(cos), f32(sin)
    sc, bi = f32(scale) * fold_scale, f32(bias) * fold_scale
    out = torch.empty_like(x)
    err = _build.lib().star_qk_ln_rope(
        x.data_ptr(), cos.data_ptr(), sin.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), out.data_ptr(), b * s, s, num_heads, float(eps),
        _build.stream_ptr(dev))
    _build.check(err, 'star_qk_ln_rope')
    LAUNCHES += 1
    return out


def _run(x, scale, bias, cos, sin, num_heads, eps, fold_scale):
    """K9 for a CUDA tensor, else the plain version."""
    if x.is_cuda:
        return _launch(x, scale, bias, cos, sin, num_heads, eps, fold_scale)
    return qk_ln_rope_plain(x, scale, bias, cos, sin, num_heads, eps,
                            fold_scale)


class _QkLnRope(torch.autograd.Function):
    """K9 forward (the plain version on the CPU); the backward recomputes
    the plain version from the saved inputs and differentiates it."""

    @staticmethod
    def forward(ctx, x, scale, bias, cos, sin, num_heads, eps, fold_scale):
        ctx.save_for_backward(x, scale, bias, cos, sin)
        ctx.args = (num_heads, eps, fold_scale)
        return _run(x, scale, bias, cos, sin, num_heads, eps, fold_scale)

    @staticmethod
    def backward(ctx, ct):
        global BACKWARDS
        BACKWARDS += 1
        with torch.profiler.record_function('qk_ln_rope_backward'):
            grads = _recompute_grads(
                ctx, lambda x, sc, bi, cos, sin: qk_ln_rope_plain(
                    x, sc, bi, cos, sin, *ctx.args), [ct])
        return (*grads[:3], None, None, None, None, None)


def qk_ln_rope(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor, num_heads: int,
               eps: float = 1e-6, fold_scale: float = 1.0) -> torch.Tensor:
    """K9. x [B, S, H*D] -> LayerNormed and rotated [B, S, H*D].
    Differentiable in x, scale and bias (plain recompute backward)."""
    if _build.needs_grad(x, scale, bias):
        return _QkLnRope.apply(x, scale, bias, cos, sin, num_heads, eps,
                               fold_scale)
    return _run(x, scale, bias, cos, sin, num_heads, eps, fold_scale)
