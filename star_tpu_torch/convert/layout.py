"""Tensor layout: reference (torch) parameter -> the port's parameter
(counterpart of star_tpu/convert/layout.py).

The port keeps torch's layouts wherever the reference has them, so most
parameters are copied as they are:

  reference                         port
  Linear   [out, in]                Linear [out, in]
  Conv2d   [out, in, kh, kw]        Conv2d (applied channels-last) as is
  Conv3d   [out, in, kt, kh, kw]    CausalConv3d as is
  Norm weight/bias                  NormParams / GroupNorm / LayerNorm
                                    weight/bias (flax 'scale' -> 'weight')

and reshapes it in two places only:

  Conv3d   [out, in, kt, 1, 1]      TConvParams [kt, 1, in, out] (K5's)
  Conv1d   [out, in, 1]             Linear [out, in]

Each function keeps the tensor's dtype and device.
"""

from __future__ import annotations

import torch


def conv3d_t11_kernel(w: torch.Tensor) -> torch.Tensor:
    """Conv3d with kernel (kt, 1, 1) -> TConvParams [kt, 1, in, out]."""
    if w.ndim != 5 or w.shape[3] != 1 or w.shape[4] != 1:
        raise ValueError(f'a (kt, 1, 1) Conv3d weight, not {tuple(w.shape)}')
    return w[:, :, :, 0, 0].permute(2, 1, 0)[:, None].contiguous()


def conv1d_as_linear(w: torch.Tensor) -> torch.Tensor:
    """Conv1d with kernel 1 -> Linear [out, in]."""
    if w.ndim != 3 or w.shape[2] != 1:
        raise ValueError(f'a kernel-1 Conv1d weight, not {tuple(w.shape)}')
    return w[:, :, 0]


def as_vector(w: torch.Tensor) -> torch.Tensor:
    """A scalar parameter (SVD's mix_factor) -> shape [1]."""
    return w.reshape(1)
