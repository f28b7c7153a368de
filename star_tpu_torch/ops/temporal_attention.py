"""Per-pixel frame attention: kernel K4
(counterpart of star_tpu/ops/temporal_attention.py).

Softmax attention over the F frames at every (batch, pixel, head) of
q/k/v in their natural [B, F, N, H*D] layout. A CUDA tensor goes through
csrc/temporal_attention.cu (d=64, F <= 16, bf16; anything else raises); a
CPU tensor through the plain version, the JAX package's `_xla_reference`.

Under autograd on a CUDA tensor the forward is the kernel, and the
backward recomputes the plain version and differentiates it
(`_contract.Kernel(recompute=True)`): the JAX package has no backward
kernel for K4 and recomputes through its einsum reference
(`star_tpu/ops/temporal_attention.py:164-171`).
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import spanned
from . import _build, _contract

_contract.kernels('temporal_attention')


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
    _contract.COUNTS['temporal_attention'] += 1
    return out


_K4 = _contract.Kernel(__name__, '_launch', 'temporal_attention_plain',
                       recompute=True)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       num_heads: int,
                       scale: float | None = None) -> torch.Tensor:
    """q/k/v [B, F, N, H*D] -> [B, F, N, H*D]; softmax over the frame axis
    independently per (pixel n, head). Differentiable (plain recompute
    backward)."""
    d = q.shape[-1] // num_heads
    return _K4(q, k, v, num_heads,
               (1.0 / math.sqrt(d)) if scale is None else scale)
