"""Training losses: v-prediction MSE + timestep-aware Fourier frequency loss
(counterpart of star_tpu/train/losses.py).

The cutoff between low and high frequencies is the 80th percentile of the
rfft2 magnitude, on the same deterministic strided 10k subsample as the
JAX package takes for large tensors; `torch.quantile` interpolates
linearly, as `jnp.quantile` does. With `freq_grad=False` (the default, as
the reference decodes pred-x0 under no_grad) the frequency term carries no
gradient and is effectively a logged metric.
"""

from __future__ import annotations

from typing import Optional

import torch


def fourier_split(x: torch.Tensor, subsample: int = 10000):
    """Per-frame rfft2 over the (H, W) axes of x [N, H, W, C], split into
    low/high frequency with a soft mask at the 80th percentile of the
    magnitude. Returns (low, high) with real/imag stacked on a trailing
    axis."""
    fft = torch.fft.rfft2(x.float(), dim=(-3, -2))
    magnitude = fft.abs()
    flat = magnitude.reshape(-1)
    n = flat.shape[0]
    if n > subsample:
        flat = flat[::n // subsample][:subsample]
    cutoff = torch.quantile(flat, 0.8)
    low_mask = torch.sigmoid(10.0 * (cutoff - magnitude))
    low = fft * low_mask
    high = fft * (1.0 - low_mask)
    stack = lambda z: torch.stack([z.real, z.imag], dim=-1)
    return stack(low), stack(high)


def star_sr_loss(v_pred: torch.Tensor, v_target: torch.Tensor,
                 t: torch.Tensor,
                 pred_x0_pixels: Optional[torch.Tensor] = None,
                 gt_pixels: Optional[torch.Tensor] = None,
                 freq_weight: float = 0.01, alpha: float = 2.0,
                 beta: float = 1.0, freq_grad: bool = False):
    """loss = MSE(v) + beta * (1 - t/999) * 0.01*(ct*L1(low) +
    (1-ct)*L1(high)), ct = (t/999)^alpha.

    Returns (scalar loss, metrics dict of 0-d tensors). t: [B]; pixels
    [B, F, H, W, 3] in [-1, 1]; if either pixels argument is None the
    frequency term is skipped."""
    loss_v = torch.mean((v_pred.float() - v_target.float()) ** 2)
    metrics = {'loss_v': loss_v}
    loss = loss_v
    if pred_x0_pixels is not None and gt_pixels is not None:
        if not freq_grad:
            pred_x0_pixels = pred_x0_pixels.detach()
        pf = pred_x0_pixels.reshape((-1,) + pred_x0_pixels.shape[-3:])
        gf = gt_pixels.reshape((-1,) + gt_pixels.shape[-3:])
        low_p, high_p = fourier_split(pf)
        low_g, high_g = fourier_split(gf)
        loss_low = torch.mean(torch.abs(low_p - low_g))
        loss_high = torch.mean(torch.abs(high_p - high_g))
        tn = t.float() / 999.0
        ct = torch.mean(tn ** alpha)
        weight_t = torch.mean(1.0 - tn)
        loss_t = freq_weight * (ct * loss_low + (1.0 - ct) * loss_high)
        loss = loss_v + beta * weight_t * loss_t
        metrics.update({'loss_low': loss_low, 'loss_high': loss_high,
                        'loss_t': loss_t})
    metrics['total_loss'] = loss
    return loss, metrics
