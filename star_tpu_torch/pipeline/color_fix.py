"""AdaIN / wavelet colour correction, batched over frames on the device
(counterpart of star_tpu/pipeline/color_fix.py).

  target  — generated frames [F, H, W, 3], 0..255
  source  — input frames [F, H', W', 3] in [-1, 1]
  returns — corrected frames [F, H, W, 3], 0..255
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _mean_std(x: torch.Tensor, eps: float = 1e-5):
    f, h, w, c = x.shape
    flat = x.reshape(f, h * w, c)
    mean = flat.mean(dim=1)
    var = flat.var(dim=1, unbiased=True) + eps
    return mean[:, None, None, :], torch.sqrt(var)[:, None, None, :]


def adaptive_instance_normalization(content: torch.Tensor,
                                    style: torch.Tensor) -> torch.Tensor:
    """Match per-frame, per-channel mean/std of content to style (ddof=1)."""
    style_mean, style_std = _mean_std(style)
    content_mean, content_std = _mean_std(content)
    return (content - content_mean) / content_std * style_std + style_mean


def adain_color_fix(target: torch.Tensor, source: torch.Tensor):
    t = target.float() / 255.0
    s = (source.float() + 1.0) / 2.0
    return torch.clamp(adaptive_instance_normalization(t, s), 0.0, 1.0) * 255.0


def wavelet_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    """Depthwise 3x3 'wavelet' blur with dilation=radius and replicate
    padding; image [F, H, W, C]."""
    kernel = torch.tensor([[0.0625, 0.125, 0.0625],
                           [0.125, 0.25, 0.125],
                           [0.0625, 0.125, 0.0625]], dtype=image.dtype,
                          device=image.device)
    c = image.shape[-1]
    x = F.pad(image.permute(0, 3, 1, 2), (radius,) * 4, mode='replicate')
    y = F.conv2d(x, kernel.expand(c, 1, 3, 3), dilation=radius, groups=c)
    return y.permute(0, 2, 3, 1)


def wavelet_decomposition(image: torch.Tensor, levels: int = 5):
    high_freq = torch.zeros_like(image)
    for i in range(levels):
        low_freq = wavelet_blur(image, 2 ** i)
        high_freq = high_freq + (image - low_freq)
        image = low_freq
    return high_freq, low_freq


def wavelet_color_fix(target: torch.Tensor, source: torch.Tensor):
    t = target.float() / 255.0
    s = (source.float() + 1.0) / 2.0
    content_high, _ = wavelet_decomposition(t)
    _, style_low = wavelet_decomposition(s)
    return torch.clamp(content_high + style_low, 0.0, 1.0) * 255.0
