"""Operators of the port. The four kernel modules each hold a CUDA kernel
wrapper, its plain PyTorch version and a launch counter:

  flash_attention       K1 (packed, d=64) and K2 (d=512)
  temporal_attention    K4
  fused_temporal_conv   K5
"""

from . import flash_attention, fused_temporal_conv, temporal_attention

KERNELS = ('flash_packed', 'flash_d512', 'temporal_attention',
           'fused_gn_silu_tconv3')


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset_launch_counts()."""
    return {'flash_packed': flash_attention.PACKED_LAUNCHES,
            'flash_d512': flash_attention.D512_LAUNCHES,
            'temporal_attention': temporal_attention.LAUNCHES,
            'fused_gn_silu_tconv3': fused_temporal_conv.LAUNCHES}


def reset_launch_counts() -> None:
    flash_attention.PACKED_LAUNCHES = 0
    flash_attention.D512_LAUNCHES = 0
    temporal_attention.LAUNCHES = 0
    fused_temporal_conv.LAUNCHES = 0
