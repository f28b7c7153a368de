"""T5 v1.1 encoder (XXL by default), the CogVideoX text conditioner
(counterpart of star_tpu/models/t5/encoder.py).

RMSNorm pre-norm (eps 1e-6), unscaled dot-product attention with no
attention mask (the reference passes input_ids only), a relative position
bias from block 0 shared by every layer (32 buckets, max distance 128,
bidirectional, bucketed on the host), gated-GELU feed-forward
gelu(wi_0 x) * wi_1 x, no biases. XXL: d_model 4096, d_ff 10240, 24
layers, 64 heads of 64. The 226-token attention stays plain matmul +
softmax, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int = 32,
                              max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket matrix [q_len, k_len]."""
    rel = np.arange(k_len)[None, :] - np.arange(q_len)[:, None]
    nb = num_buckets // 2
    ret = (rel > 0).astype(np.int64) * nb
    n = np.abs(rel)
    max_exact = nb // 2
    val_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (nb - max_exact)).astype(np.int64)
    val_large = np.minimum(val_large, nb - 1)
    return ret + np.where(n < max_exact, n, val_large)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps)).to(x.dtype) \
            * self.scale.to(x.dtype)


class T5Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int):
        super().__init__()
        self.num_heads = num_heads
        self.ln_attn = RMSNorm(d_model)
        for name in ('q', 'k', 'v', 'o'):
            setattr(self, name, nn.Linear(d_model, d_model, bias=False))
        self.ln_mlp = RMSNorm(d_model)
        self.wi_0 = nn.Linear(d_model, d_ff, bias=False)
        self.wi_1 = nn.Linear(d_model, d_ff, bias=False)
        self.wo = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x, pos_bias):
        b, s, c = x.shape
        heads = self.num_heads
        h = self.ln_attn(x)
        q, k, v = (getattr(self, n)(h).reshape(b, s, heads, c // heads)
                   for n in 'qkv')
        # no 1/sqrt(d) scaling; fp32 logits, bias added before the softmax
        logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
        probs = torch.softmax(logits + pos_bias, dim=-1)
        attn = torch.einsum('bhqk,bkhd->bqhd', probs.to(x.dtype), v)
        x = x + self.o(attn.reshape(b, s, c))
        h = self.ln_mlp(x)
        g = F.gelu(self.wi_0(h).float(), approximate='tanh').to(x.dtype)
        return x + self.wo(g * self.wi_1(h))


class T5Encoder(nn.Module):
    def __init__(self, vocab_size: int = 32128, d_model: int = 4096,
                 d_ff: int = 10240, num_heads: int = 64, num_layers: int = 24,
                 rel_buckets: int = 32, rel_max_distance: int = 128):
        super().__init__()
        self.rel_buckets, self.rel_max_distance = rel_buckets, \
            rel_max_distance
        self.num_layers = num_layers
        self.token_embedding = nn.Parameter(torch.randn(vocab_size, d_model))
        self.relative_attention_bias = nn.Parameter(
            torch.randn(rel_buckets, num_heads) * 0.1)
        for i in range(num_layers):
            setattr(self, f'block_{i}', T5Block(d_model, num_heads, d_ff))
        self.final_norm = RMSNorm(d_model)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] int -> last hidden state [B, S, d_model]."""
        s = tokens.shape[1]
        x = self.token_embedding[tokens.long()]
        buckets = torch.from_numpy(relative_position_buckets(
            s, s, self.rel_buckets, self.rel_max_distance)).to(tokens.device)
        pos_bias = self.relative_attention_bias.float()[buckets] \
            .permute(2, 0, 1)[None]                          # [1, H, S, S]
        for i in range(self.num_layers):
            x = getattr(self, f'block_{i}')(x, pos_bias)
        return self.final_norm(x)
