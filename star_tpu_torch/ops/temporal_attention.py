"""Per-pixel frame attention: kernel K4
(counterpart of star_tpu/ops/temporal_attention.py).

Softmax attention over the F frames at every (batch, pixel, head) of
q/k/v in their natural [B, F, N, H*D] layout. A CUDA tensor goes through
csrc/temporal_attention.cu (d=64, F <= 16, bf16; anything else raises); a
CPU tensor through the plain version, the JAX package's `_xla_reference`.

Under autograd the forward is the same, and the backward recomputes the
plain version and differentiates it, on CUDA tensors too: the JAX package
has no backward kernel for K4 and recomputes through its einsum reference
(`star_tpu/ops/temporal_attention.py:164-171`). That recompute is the one
place (with K5's) where a plain version runs on the card, by design.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import spanned
from . import _build

LAUNCHES = 0


def temporal_attention_plain(q, k, v, num_heads: int, scale: float):
    b, f, n, hd = q.shape
    d = hd // num_heads
    q5 = q.reshape(b, f, n, num_heads, d).float()
    k5 = k.reshape(b, f, n, num_heads, d).float()
    v5 = v.reshape(b, f, n, num_heads, d).float()
    logits = torch.einsum('bfnhd,bgnhd->bhfgn', q5, k5) * scale
    probs = torch.softmax(logits, dim=3).to(q.dtype).float()
    out = torch.einsum('bhfgn,bgnhd->bfnhd', probs, v5)
    return out.reshape(b, f, n, hd).to(q.dtype)


@spanned('kernel.K4')
def _launch(q, k, v, num_heads: int, scale: float):
    global LAUNCHES
    b, f, n, hd = q.shape
    d = hd // num_heads
    if d != 64 or not 1 <= f <= 16:
        raise ValueError(f'temporal attention kernel takes d=64 and F<=16, '
                         f'got d={d} F={f}')
    for t in (q, k, v):
        if t.shape != q.shape or t.dtype != torch.bfloat16 \
                or not t.is_contiguous() or not t.is_cuda:
            raise ValueError('temporal attention kernel takes contiguous '
                             'bf16 CUDA q/k/v of one shape')
    out = torch.empty_like(q)
    err = _build.lib().star_temporal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, f, n,
        num_heads, float(scale), _build.stream_ptr(q.device))
    _build.check(err, 'star_temporal_attention')
    LAUNCHES += 1
    return out


def _forward(q, k, v, num_heads: int, scale: float):
    if q.is_cuda:
        return _launch(q, k, v, num_heads, scale)
    return temporal_attention_plain(q, k, v, num_heads, scale)


class _TemporalAttention(torch.autograd.Function):
    """K4 forward (the plain version on the CPU); the backward recomputes
    `temporal_attention_plain` from the saved q/k/v and differentiates it."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _forward(q, k, v, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = temporal_attention_plain(*qkv, ctx.num_heads, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       num_heads: int,
                       scale: float | None = None) -> torch.Tensor:
    """q/k/v [B, F, N, H*D] -> [B, F, N, H*D]; softmax over the frame axis
    independently per (pixel n, head). Differentiable (plain recompute
    backward)."""
    d = q.shape[-1] // num_heads
    s = (1.0 / math.sqrt(d)) if scale is None else scale
    if _build.needs_grad(q, k, v):
        return _TemporalAttention.apply(q, k, v, num_heads, s)
    return _forward(q, k, v, num_heads, s)
