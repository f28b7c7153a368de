"""Multi-head attention entry points with the JAX package's semantic
routing (counterpart of star_tpu/ops/attention.py).

Long self-attention (Sq >= 512 and Sk >= 512) goes to the flash kernels;
short sequences — the 77-token text cross-attention, the 260-token mid
scale of the UNet — stay a plain matmul + softmax, as XLA computes them in
the JAX package. The TPU tiling conditions of the JAX dispatcher are gone:
the CUDA kernels handle ragged edges themselves.
"""

from __future__ import annotations

import math

import torch

from .flash_attention import (LN2, attention_plain, flash_attention,
                              flash_attention_packed)

FLASH_MIN_SEQ = 512


def _long(sq: int, sk: int) -> bool:
    return sq >= FLASH_MIN_SEQ and sk >= FLASH_MIN_SEQ


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D], unmasked."""
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if _long(q.shape[1], k.shape[1]):
        return flash_attention(q, k, v, scale)
    return attention_plain(q, k, v, scale)


def dot_product_attention_packed(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, num_heads: int,
                                 scale: float | None = None,
                                 kv_valid: int | None = None,
                                 prescaled: bool = False) -> torch.Tensor:
    """Natural-layout attention: q/k/v [B, S, H*D] -> [B, S, H*D]; keys at
    or beyond kv_valid get no weight."""
    b, s, c = q.shape
    d = c // num_heads
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if _long(s, k.shape[1]):
        return flash_attention_packed(q, k, v, num_heads, scale,
                                      kv_valid=kv_valid, prescaled=prescaled)
    kv = k.shape[1] if kv_valid is None else min(kv_valid, k.shape[1])
    to4 = lambda t: t.reshape(t.shape[0], t.shape[1], num_heads, d)
    out = attention_plain(to4(q), to4(k[:, :kv]), to4(v[:, :kv]),
                          LN2 if prescaled else scale)
    return out.reshape(b, s, c)
