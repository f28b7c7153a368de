"""Normalisation on channels-last tensors with fp32 statistics
(counterpart of star_tpu/ops/norms.py).

Statistics accumulate in float32 even under bf16 compute; the bulk apply
runs in the compute dtype with the subtract-first form
(x - mean) * a + b, exactly as the JAX package does.

The models' LayerNorms run the kernels K10 and K11 (ops/fused_ln.py),
which apply in fp32 and round once; `layer_norm` and `liem_layer_norm`
here are the JAX package's eager functions, kept as its counterparts.
`gated_layer_norm` serves the SpatialLIEM-gated norm1, which no kernel
computes.
"""

from __future__ import annotations

import torch


def _mean_f32(x: torch.Tensor, dims, keepdim=True) -> torch.Tensor:
    return torch.mean(x, dim=dims, keepdim=keepdim, dtype=torch.float32)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last (channel) axis; x [N, ..., C], statistics
    pooled over every axis but the first and per group of channels."""
    c = x.shape[-1]
    assert c % num_groups == 0, (c, num_groups)
    n = x.shape[0]
    dtype = x.dtype
    xg = x.reshape(n, -1, num_groups, c // num_groups)
    mean = _mean_f32(xg, (1, 3))                       # [N,1,G,1]
    mean2 = _mean_f32(xg.float().square(), (1, 3))
    inv = torch.rsqrt(mean2 - mean.square() + eps)
    a = inv * scale.float().reshape(num_groups, c // num_groups)
    bshape = (n,) + (1,) * (x.ndim - 2) + (c,)
    mean_b = mean.expand(n, 1, num_groups, c // num_groups).reshape(bshape)
    a = a.expand(n, 1, num_groups, c // num_groups).reshape(bshape)
    return (x - mean_b.to(dtype)) * a.to(dtype) + bias.to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics."""
    dtype = x.dtype
    mean = _mean_f32(x, (-1,))
    m2 = _mean_f32(x.float().square(), (-1,))
    var = torch.clamp(m2 - mean.square(), min=0.0)
    a = torch.rsqrt(var + eps).to(dtype)
    return (x - mean.to(dtype)) * a * scale.to(dtype) + bias.to(dtype)


def gated_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm(g * x) for a per-token fp32 gate g [..., 1], folded into
    the LN coefficients so g*x is never materialised."""
    dtype = x.dtype
    mean = _mean_f32(x, (-1,))
    m2 = _mean_f32(x.float().square(), (-1,))
    g = g.float()
    var = torch.clamp(m2 - mean.square(), min=0.0)
    a = (g * torch.rsqrt(var * g.square() + eps)).to(dtype)
    return (x - mean.to(dtype)) * a * scale.to(dtype) + bias.to(dtype)


def liem_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    gate_w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm(g * x) with the TemporalLIEM gate
    g = sigmoid(w0*max_c(x) + w1*mean_c(x)) folded into the coefficients.
    gate_w: [2] (w0 -> channel max, w1 -> channel mean)."""
    dtype = x.dtype
    mx = torch.amax(x, dim=-1, keepdim=True).float()
    mean = _mean_f32(x, (-1,))
    m2 = _mean_f32(x.float().square(), (-1,))
    gw = gate_w.float()
    g = torch.sigmoid(mx * gw[0] + mean * gw[1])
    var = torch.clamp(m2 - mean.square(), min=0.0)
    a = (g * torch.rsqrt(var * g.square() + eps)).to(dtype)
    return (x - mean.to(dtype)) * a * scale.to(dtype) + bias.to(dtype)
