"""Parameter-holding layers shared by the port's models.

Module attribute names follow the JAX package's flax module names, so a
state_dict key is the flax parameter path with '/' -> '.' and the leaf
renamed (convert/from_flax.py). Convolutions take channels-last tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.conv3x3 import conv2d_nhwc
from ..ops.fused_ln import fused_ln
from ..ops.norms import group_norm


class Conv2d(nn.Conv2d):
    """nn.Conv2d (OIHW weight) applied to a channels-last [N, H, W, C]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.weight, self.bias, self.stride,
                           self.padding)


class NormParams(nn.Module):
    """GroupNorm / LayerNorm parameters (flax 'scale' -> 'weight', 'bias'),
    for fused ops that apply the norm themselves."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class GroupNorm(NormParams):
    """Channels-last GroupNorm with fp32 statistics over every non-batch
    axis ([BF, H, W, C] -> per frame, [B, F, H, W, C] -> per video), the
    SiLU after it with `silu`: kernel K13 on the card (ops/norms.py)."""

    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__(channels)
        self.num_groups, self.eps = num_groups, eps

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups,
                          self.eps, silu=silu)


class LayerNorm(NormParams):
    """LayerNorm over the last axis through kernel K10 (fp32 statistics);
    the UNet's transformer blocks pass its parameters to K11 instead."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_ln(x, self.weight, self.bias, self.eps)


class TConvParams(nn.Module):
    """(3,1,1) temporal conv parameters in the layout the fused kernel K5
    takes: weight [3, 1, Cin, Cout] (the flax (3,1) conv kernel, kept as
    is), bias [Cout]."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(3, 1, in_channels, features))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.normal_(self.weight, std=(3 * in_channels) ** -0.5)


def zero_(module: nn.Module) -> nn.Module:
    """Zero the module's parameters and mark it zero-initialised (the flax
    modules built with kernel_init=zeros), so a re-initialisation keeps
    the zero-init invariants (UNet output 0, ControlNet residuals 0)."""
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()
    module.zero_init = True
    return module
