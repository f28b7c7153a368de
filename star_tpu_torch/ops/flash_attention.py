"""Flash attention forward: kernels K1 and K2
(counterpart of star_tpu/ops/flash_attention.py).

  K1 `flash_attention_packed`: q/k/v [B, S, H*D] natural layout, d=64,
     optional `kv_valid` dead-tail mask and `prescaled` q — the UNet's
     spatial self-attention (Pallas `_flash_packed_kernel`).
  K2 `flash_attention`: q/k/v [B, S, H, D], here d=512 single head — the
     SVD-VAE mid attention (Pallas `_flash_kernel`, forward).

Both run the CUDA kernel in csrc/flash_fwd.cu for a CUDA tensor (or raise
if it does not take the input), and the plain PyTorch version for a CPU
tensor. The plain version is the JAX package's `_xla_reference`: fp32
logits, fp32 softmax, probabilities in the input dtype, fp32 accumulation.
"""

from __future__ import annotations

import math

import torch

from . import _build

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# launches of each kernel (plain ints; chip_smoke.py resets and reads them)
PACKED_LAUNCHES = 0   # K1, d=64
D512_LAUNCHES = 0     # K2, d=512


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """[B, Sq, H, D] x [B, Sk, H, D] -> [B, Sq, H, D] through materialised
    fp32 logits (the reference every flash kernel is held to)."""
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum('bhqk,bkhd->bqhd', probs.float(), v.float())
    return out.to(q.dtype)


def flash_attention_packed_plain(q, k, v, num_heads, scale, kv_valid=None,
                                 prescaled=False):
    b, s, c = q.shape
    d = c // num_heads
    kv = k.shape[1] if kv_valid is None else min(kv_valid, k.shape[1])
    to4 = lambda t: t.reshape(t.shape[0], t.shape[1], num_heads, d)
    # a prescaled q carries scale*log2(e): logits*ln2 are natural-log logits
    out = attention_plain(to4(q), to4(k[:, :kv]), to4(v[:, :kv]),
                          LN2 if prescaled else scale)
    return out.reshape(b, s, c)


def _launch(q, k, v, heads: int, d: int, c: float, kv_valid: int):
    """Launch csrc/flash_fwd.cu on q/k/v whose rows are [S, heads*d] with
    head h at column h*d; returns the output in q's layout."""
    global PACKED_LAUNCHES, D512_LAUNCHES
    name = {64: 'star_flash_fwd_d64', 512: 'star_flash_fwd_d512'}.get(d)
    if name is None:
        raise ValueError(f'flash kernel takes head_dim 64 or 512, not {d}')
    for t in (q, k, v):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError('flash kernel takes bf16 CUDA tensors, got '
                             f'{t.dtype} on {t.device}')
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('flash kernel takes contiguous 16-byte '
                             'aligned q/k/v')
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f'flash kernel: q {tuple(q.shape)} k '
                         f'{tuple(k.shape)} v {tuple(v.shape)}')
    bsz, sq = q.shape[0], q.shape[1]
    sk = k.shape[1]
    row = heads * d
    out = torch.empty_like(q)
    fn = getattr(_build.lib(), name)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             bsz, heads, sq, sk, max(0, min(kv_valid, sk)),
             sq * row, sk * row, sk * row, sq * row, row, row, row, row,
             float(c), _build.stream_ptr(q.device))
    _build.check(err, name)
    if d == 64:
        PACKED_LAUNCHES += 1
    else:
        D512_LAUNCHES += 1
    return out


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int, scale: float | None = None,
                           kv_valid: int | None = None,
                           prescaled: bool = False) -> torch.Tensor:
    """K1. q/k/v [B, S, H*D] -> [B, S, H*D], non-causal softmax attention
    per head; keys >= kv_valid get no weight; with `prescaled` q already
    carries scale*log2(e)."""
    d = q.shape[-1] // num_heads
    s = (1.0 / math.sqrt(d)) if scale is None else scale
    if q.is_cuda:
        kv = k.shape[1] if kv_valid is None else kv_valid
        return _launch(q, k, v, num_heads, d,
                       1.0 if prescaled else s * LOG2E, kv)
    return flash_attention_packed_plain(q, k, v, num_heads, s, kv_valid,
                                        prescaled)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """K2. q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D]."""
    b, sq, h, d = q.shape
    s = (1.0 / math.sqrt(d)) if scale is None else scale
    if q.is_cuda:
        return _launch(q, k, v, h, d, s * LOG2E, k.shape[1])
    return attention_plain(q, k, v, s)
