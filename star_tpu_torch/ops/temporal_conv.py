"""3-tap temporal convolution over frames (counterpart of
star_tpu/ops/temporal_conv.py).

The JAX package leaves this conv to XLA, so it stays stock torch ops here:
the chain that the UNet's TemporalConvBlockV2 runs when dropout is active
(the deterministic chain is kernel K5). The JAX function picks one of two
spellings by activation size (an im2col GEMM at the UNet's latent scales,
a native (3,1) conv at the VAE's pixel scales); both compute the same
function, which is the one computed here: taps accumulated in fp32, SAME
padding over F, the fp32 bias added and the result rounded once to the
input's dtype. bf16 operands multiply through K5's plain version's tap
product (a bf16 GEMM with fp32 accumulation, and JAX's VJP of it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .fused_temporal_conv import _TapProduct


def temporal_conv3(x: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """x [B, F, N, Cin], kernel [3, 1, Cin, Cout] (the fp32 parameter),
    bias [Cout] -> [B, F, N, Cout] in x.dtype."""
    b, f, n, cin = x.shape
    cout = kernel.shape[-1]
    kb = kernel.reshape(3 * cin, cout).to(x.dtype)
    xp = F.pad(x, (0, 0, 0, 0, 1, 1))
    xs = torch.cat([xp[:, tap:tap + f] for tap in range(3)], dim=-1)
    if x.dtype == torch.bfloat16:
        y = _TapProduct.apply(xs.reshape(-1, 3 * cin), kb) \
            .reshape(b, f, n, cout)
    else:
        y = torch.matmul(xs.float(), kb.float())
    return (y + bias.float()).to(x.dtype)


def temporal_conv3_video(x5: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """x5 [B, F, H, W, C] through the (3,1,1) conv: the taps accumulate in
    fp32 and round to x5.dtype, then the bias is added in x5.dtype (the
    JAX function's order of rounding)."""
    k5 = kernel.to(x5.dtype).float().reshape(3, kernel.shape[2],
                                             kernel.shape[3])
    y = F.conv3d(x5.float().permute(0, 4, 1, 2, 3),
                 k5.permute(2, 1, 0)[..., None, None], padding=(1, 0, 0))
    return y.permute(0, 2, 3, 4, 1).to(x5.dtype) + bias.to(x5.dtype)
