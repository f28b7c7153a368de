"""Operators of the port. The kernel modules each hold CUDA kernel
wrappers, their plain PyTorch versions and launch counters:

  flash_attention       K1 (packed, d=64), K2 (d=512; and `with_l`, the
                        d=64 training forward that writes the lse) and K3
                        (the d=64 backward)
  temporal_attention    K4
  fused_temporal_conv   K5
  conv3x3               K6 (fused GN + SiLU + 3x3 conv)
  upsample_conv         K7 (fused nearest-2x + 3x3 conv) and K8 (2x2 phase
                        interleave)
  qk_ln_rope            K9 (fused qk-LayerNorm + half-split RoPE)
  fused_ln              K10 (LayerNorm, optionally LIEM-gated) and K11
                        (residual add + [LIEM gate +] LayerNorm)

K1/K2-d64 (with K3), K4, K5, K10 and K11 are differentiable through
torch.autograd.Function; K2-d512, K6, K7, K8 and K9 have no backward
and raise under grad.
"""

from . import (conv3x3, flash_attention, fused_ln, fused_temporal_conv,
               qk_ln_rope, temporal_attention, upsample_conv)

KERNELS = ('flash_packed', 'flash_packed_lse', 'flash_bwd', 'flash_d512',
           'temporal_attention', 'fused_gn_silu_tconv3', 'conv3x3',
           'upsample_conv2x', 'interleave2x2', 'qk_ln_rope', 'fused_ln',
           'fused_resid_ln')


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset_launch_counts()."""
    return {'flash_packed': flash_attention.PACKED_LAUNCHES,
            'flash_packed_lse': flash_attention.LSE_LAUNCHES,
            'flash_bwd': flash_attention.BWD_LAUNCHES,
            'flash_d512': flash_attention.D512_LAUNCHES,
            'temporal_attention': temporal_attention.LAUNCHES,
            'fused_gn_silu_tconv3': fused_temporal_conv.LAUNCHES,
            'conv3x3': conv3x3.LAUNCHES,
            'upsample_conv2x': upsample_conv.UPSAMPLE_LAUNCHES,
            'interleave2x2': upsample_conv.INTERLEAVE_LAUNCHES,
            'qk_ln_rope': qk_ln_rope.LAUNCHES,
            'fused_ln': fused_ln.LN_LAUNCHES,
            'fused_resid_ln': fused_ln.RESID_LN_LAUNCHES}


def reset_launch_counts() -> None:
    flash_attention.PACKED_LAUNCHES = 0
    flash_attention.LSE_LAUNCHES = 0
    flash_attention.BWD_LAUNCHES = 0
    flash_attention.D512_LAUNCHES = 0
    temporal_attention.LAUNCHES = 0
    fused_temporal_conv.LAUNCHES = 0
    conv3x3.LAUNCHES = 0
    upsample_conv.UPSAMPLE_LAUNCHES = 0
    upsample_conv.INTERLEAVE_LAUNCHES = 0
    qk_ln_rope.LAUNCHES = 0
    fused_ln.LN_LAUNCHES = 0
    fused_ln.RESID_LN_LAUNCHES = 0
