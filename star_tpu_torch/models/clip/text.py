"""OpenCLIP ViT-H-14 text tower, penultimate layer
(counterpart of star_tpu/models/clip/text.py).

Token + positional embedding, causal transformer stopped one block before
the end, then ln_final: tokens [B, 77] -> features [B, 77, width]. The 77
tokens are short, so attention is a plain matmul + fp32 softmax.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import LayerNorm


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj = nn.Linear(width, 3 * width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, mask):
        b, s, c = x.shape
        hd = c // self.heads
        q, k, v = (t.reshape(b, s, self.heads, hd)
                   for t in self.in_proj(x).chunk(3, dim=-1))
        logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
        logits = logits * (1.0 / math.sqrt(hd)) + mask
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum('bhqk,bkhd->bqhd', probs, v)
        return self.out_proj(out.reshape(b, s, c))


class CLIPBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = LayerNorm(width)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        h = self.mlp_fc(self.ln_2(x))
        h = F.gelu(h.float(), approximate='none').to(x.dtype)
        return x + self.mlp_proj(h)


class CLIPTextEncoder(nn.Module):
    """tokens [B, 77] int -> features [B, 77, width]."""

    def __init__(self, vocab_size: int = 49408, width: int = 1024,
                 heads: int = 16, layers: int = 24, context_length: int = 77,
                 penultimate: bool = True):
        super().__init__()
        self.token_embedding = nn.Parameter(
            torch.randn(vocab_size, width) * 0.02)
        self.positional_embedding = nn.Parameter(
            torch.randn(context_length, width) * 0.01)
        n_blocks = layers - (1 if penultimate else 0)
        for i in range(n_blocks):
            setattr(self, f'resblock_{i}', CLIPBlock(width, heads))
        self.n_blocks = n_blocks
        self.ln_final = LayerNorm(width)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, s = tokens.shape
        dtype = self.ln_final.weight.dtype
        x = (self.token_embedding[tokens.long()].to(dtype)
             + self.positional_embedding[None, :s].to(dtype))
        mask = torch.triu(torch.full((s, s), float('-inf'),
                                     device=x.device), diagonal=1)
        for i in range(self.n_blocks):
            x = getattr(self, f'resblock_{i}')(x, mask)
        return self.ln_final(x)
