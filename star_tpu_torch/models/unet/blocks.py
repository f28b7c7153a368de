"""Building blocks of the I2VGen-XL video UNet
(counterpart of star_tpu/models/unet/blocks.py).

Channels-last throughout: the spatial stream is [B*F, H, W, C], the
temporal stream [B, F, H*W, C]. Attention goes through ops.attention
(flash kernel K1 for long self-attention, plain for the text
cross-attention), frame attention through K4, the temporal conv chain
through the fused GN+SiLU+tconv kernel K5 with threaded statistics, and
the transformer streams' LayerNorms through K10 (the TemporalLIEM-gated
norm1) and K11 (each attention's residual add fused with the next norm).
Dropout is not ported: the blocks run the deterministic mode, the one
inference and training (`deterministic=True`) take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import dot_product_attention_packed
from ...ops.fused_temporal_conv import fused_gn_silu_tconv3
from ...ops.fused_ln import fused_ln, fused_resid_ln
from ...ops.norms import gated_layer_norm
from ...ops.temporal_attention import temporal_attention
from ...ops.upsample_conv import upsample_conv2x_cropped
from ..layers import (Conv2d, GroupNorm, LayerNorm, NormParams, TConvParams,
                      zero_)


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] -> [B, dim] fp32, cos-first layout."""
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                             device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def silu32(x: torch.Tensor) -> torch.Tensor:
    """SiLU computed in fp32, returned in x.dtype."""
    return F.silu(x.float()).to(x.dtype)


class Attention(nn.Module):
    """Multi-head (cross-)attention: q from x, k/v from context (or x)."""

    def __init__(self, query_dim: int, context_dim: int, num_heads: int,
                 head_dim: int, out_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, out_dim)

    def forward(self, x, context=None):
        context = x if context is None else context
        out = dot_product_attention_packed(self.to_q(x), self.to_k(context),
                                           self.to_v(context), self.num_heads)
        return self.to_out(out)


class FeedForwardGEGLU(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.proj = nn.Linear(dim, inner * 2)
        self.out = nn.Linear(inner, dim)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        h = h * F.gelu(gate.float(), approximate='tanh').to(h.dtype)
        return self.out(h)


class SpatialLIEM(nn.Module):
    """Spatial LIEM gate: channel max/mean -> 7x7 conv -> fp32 sigmoid."""

    def __init__(self):
        super().__init__()
        self.conv = Conv2d(2, 1, 7, padding=3, bias=False)

    def forward(self, x):            # x [BF, H, W, C] -> gate [BF, H, W, 1]
        w = torch.cat([torch.amax(x, dim=-1, keepdim=True),
                       torch.mean(x, dim=-1, keepdim=True)], dim=-1)
        return torch.sigmoid(self.conv(w).float())


class TemporalLIEM(nn.Module):
    """Temporal LIEM gate weights: the [2] vector (w_max, w_mean) that K10
    and K11 fold into the LayerNorm."""

    def __init__(self):
        super().__init__()
        self.proj = nn.Linear(2, 1, bias=False)

    def gate_weights(self) -> torch.Tensor:
        return self.proj.weight[0]


class SpatialTransformerBlock(nn.Module):
    """LIEM gate -> self-attn -> text cross-attn -> GEGLU FF; residuals add
    to the ungated stream, each attention's add fused with the next
    LayerNorm (K11). With cfg_split, x carries one copy of a CFG pair and
    is tiled right before the cross-attention: K11 runs on the half batch
    and both of its outputs are tiled, the two halves being identical."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 context_dim: int):
        super().__init__()
        self.local1 = SpatialLIEM()
        self.norm1 = NormParams(dim)
        self.attn1 = Attention(dim, dim, num_heads, head_dim, dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, context_dim, num_heads, head_dim, dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForwardGEGLU(dim)
        self.dim = dim

    def forward(self, x, context, h: int, w: int, cfg_split: bool = False):
        bf = x.shape[0]
        g = self.local1(x.reshape(bf, h, w, self.dim))
        y = self.attn1(gated_layer_norm(x, self.norm1.weight, self.norm1.bias,
                                        g.reshape(bf, h * w, 1)))
        n2, x = fused_resid_ln(y, self.norm2.weight, self.norm2.bias, x,
                               eps=self.norm2.eps)
        if cfg_split:
            n2, x = torch.cat([n2, n2], dim=0), torch.cat([x, x], dim=0)
        n3, x = fused_resid_ln(self.attn2(n2, context), self.norm3.weight,
                               self.norm3.bias, x, eps=self.norm3.eps)
        return self.ff(n3) + x


class TemporalAttentionInplace(nn.Module):
    """Frame attention on [B, F, N, C] through kernel K4, with no transpose
    of the activation (same parameters as Attention)."""

    def __init__(self, in_dim: int, num_heads: int, head_dim: int,
                 out_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.to_q = nn.Linear(in_dim, inner, bias=False)
        self.to_k = nn.Linear(in_dim, inner, bias=False)
        self.to_v = nn.Linear(in_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, out_dim)

    def forward(self, x):
        out = temporal_attention(self.to_q(x), self.to_k(x), self.to_v(x),
                                 self.num_heads)
        return self.to_out(out)


class TemporalTransformerBlock(nn.Module):
    """Two LIEM-gated temporal self-attentions and a GEGLU FF, on
    [B, F, N, C]; each gate folds into its LayerNorm: norm1 is K10 gated,
    and each attention's residual add runs with the next norm as K11
    (gated for norm2)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int):
        super().__init__()
        self.local1 = TemporalLIEM()
        self.norm1 = NormParams(dim)
        self.attn1 = TemporalAttentionInplace(dim, num_heads, head_dim, dim)
        self.local2 = TemporalLIEM()
        self.norm2 = NormParams(dim)
        self.attn2 = TemporalAttentionInplace(dim, num_heads, head_dim, dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForwardGEGLU(dim)

    def forward(self, x):
        n1 = fused_ln(x, self.norm1.weight, self.norm1.bias,
                      gate_w=self.local1.gate_weights())
        n2, x = fused_resid_ln(self.attn1(n1), self.norm2.weight,
                               self.norm2.bias, x,
                               gate_w=self.local2.gate_weights())
        n3, x = fused_resid_ln(self.attn2(n2), self.norm3.weight,
                               self.norm3.bias, x, eps=self.norm3.eps)
        return self.ff(n3) + x


class SpatialTransformer(nn.Module):
    """Per-frame transformer over H*W tokens with text cross-attention."""

    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 context_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        self.norm = GroupNorm(channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.block = SpatialTransformerBlock(inner, num_heads, head_dim,
                                             context_dim)
        self.proj_out = zero_(nn.Linear(inner, channels))

    def forward(self, x, context, cfg_split: bool = False):
        bf, h, w, c = x.shape
        x_in = x
        y = self.proj_in(self.norm(x).reshape(bf, h * w, c))
        y = self.proj_out(self.block(y, context, h, w, cfg_split))
        if cfg_split:
            x_in = torch.cat([x_in, x_in], dim=0)
        return y.reshape(-1, h, w, c) + x_in


class TemporalTransformer(nn.Module):
    """Per-pixel transformer over the F frames; [B, F, H, W, C] in and out."""

    def __init__(self, channels: int, num_heads: int, head_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        self.norm = GroupNorm(channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.block = TemporalTransformerBlock(inner, num_heads, head_dim)
        self.proj_out = zero_(nn.Linear(inner, channels))

    def forward(self, x):
        b, f, h, w, c = x.shape
        y = self.proj_in(self.norm(x).reshape(b, f, h * w, c))
        y = self.proj_out(self.block(y))
        return y.reshape(b, f, h, w, c) + x


class TemporalConvBlockV2(nn.Module):
    """Four GN+SiLU+(3,1,1)-conv stages with a residual, each one call of
    the fused kernel K5: GN statistics thread from stage to stage and the
    residual folds into the last stage."""
    names = ('conv1', 'conv2', 'conv3', 'conv4')

    def __init__(self, channels: int):
        super().__init__()
        for n in self.names:
            setattr(self, f'{n}_norm', NormParams(channels))
            cv = TConvParams(channels, channels)
            setattr(self, n, zero_(cv) if n == 'conv4' else cv)

    def forward(self, x):                  # x [B, F, H, W, C]
        b, f, h, w, c = x.shape
        identity = x.reshape(b, f, h * w, c)
        y, stats = identity, None
        for i, n in enumerate(self.names):
            gn, cv = getattr(self, f'{n}_norm'), getattr(self, n)
            last = i == 3
            y, stats = fused_gn_silu_tconv3(
                y, gn.weight, gn.bias, cv.weight, cv.bias, stats=stats,
                residual=identity if last else None, want_stats=not last)
        return y.reshape(b, f, h, w, c)


class ResBlock(nn.Module):
    """GN/SiLU/conv residual block with the timestep-embedding add and a
    trailing temporal conv block."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int):
        super().__init__()
        self.in_norm = GroupNorm(in_channels)
        self.in_conv = Conv2d(in_channels, out_channels, 3, padding=1)
        self.emb_proj = nn.Linear(emb_dim, out_channels)
        self.out_norm = GroupNorm(out_channels)
        self.out_conv = zero_(Conv2d(out_channels, out_channels, 3,
                                     padding=1))
        self.skip = (Conv2d(in_channels, out_channels, 1)
                     if in_channels != out_channels else None)
        self.temporal_conv = TemporalConvBlockV2(out_channels)

    def forward(self, x, emb, frames: int):
        bf, hh, ww, _ = x.shape
        h = self.in_conv(silu32(self.in_norm(x)))
        h = h + self.emb_proj(silu32(emb))[:, None, None, :]
        h = self.out_conv(silu32(self.out_norm(h)))
        h = (x if self.skip is None else self.skip(x)) + h
        c = h.shape[-1]
        h5 = self.temporal_conv(h.reshape(bf // frames, frames, hh, ww, c))
        return h5.reshape(bf, hh, ww, c)


class Downsample(nn.Module):
    """Stride-2 3x3 conv with padding (2, 1): H/2+1 x W/2."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=(2, 1))

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x, crop one row top and bottom, 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return upsample_conv2x_cropped(x, self.conv.weight, self.conv.bias)


