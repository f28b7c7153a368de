"""Fidelity metrics, PSNR and SSIM (counterpart of
star_tpu/utils/metrics.py): SSIM after Wang et al. 2004, an 11x11 Gaussian
window of sigma 1.5 applied without padding, K1 = 0.01, K2 = 0.03.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor,
         max_val: float = 255.0) -> torch.Tensor:
    """Mean PSNR over the leading dims; a/b: [..., H, W, C]."""
    mse = torch.mean((a.float() - b.float()) ** 2, dim=(-3, -2, -1))
    return torch.mean(10.0 * torch.log10(max_val ** 2
                                         / torch.clamp(mse, min=1e-12)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def _filter(x: torch.Tensor, k2d: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID filter of x [N, H, W, C] -> [N, H-10, W-10, C]."""
    c = x.shape[-1]
    w = k2d[None, None].expand(c, 1, *k2d.shape)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, groups=c)
    return y.permute(0, 2, 3, 1)


def ssim(a: torch.Tensor, b: torch.Tensor,
         max_val: float = 255.0) -> torch.Tensor:
    """Mean SSIM; a/b: [N, H, W, C] (frames as the batch)."""
    a32, b32 = a.float(), b.float()
    k = torch.from_numpy(_gaussian_window()).to(a32.device)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a, mu_b = _filter(a32, k), _filter(b32, k)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = _filter(a32 * a32, k) - mu_aa
    s_bb = _filter(b32 * b32, k) - mu_bb
    s_ab = _filter(a32 * b32, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return torch.mean(num / den)
