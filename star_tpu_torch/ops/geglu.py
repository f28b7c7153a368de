"""The UNet's GEGLU: kernel K12 (no kernel of the JAX package: XLA fuses
the split, fp32 GELU, cast and product of
star_tpu/models/unet/blocks.py:108 into one loop).

p [..., 2*inner] -> [..., inner]: with h, gate = p.chunk(2, -1),
h * gelu_tanh(float(gate)) rounded to h's dtype, then the product rounded.
A CUDA tensor goes through csrc/geglu.cu (contiguous, 16-byte aligned bf16,
inner a multiple of 8; anything else raises); a CPU tensor through the
plain version, the expression `FeedForwardGEGLU` ran before.

Under autograd on a CUDA tensor the forward is the kernel, and the
backward recomputes the plain version from the saved p and differentiates
it, as K4's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import spanned
from . import _build, _contract

_contract.kernels('geglu')


def geglu_plain(p):
    h, gate = p.chunk(2, dim=-1)
    return h * F.gelu(gate.float(), approximate='tanh').to(h.dtype)


@spanned('kernel.K12')
def _launch(p):
    inner = p.shape[-1] // 2
    if p.shape[-1] <= 0 or p.shape[-1] % 16:
        raise ValueError(f'GEGLU kernel takes [..., 2*inner] with inner a '
                         f'multiple of 8, got {tuple(p.shape)}')
    if p.dtype != torch.bfloat16 or not p.is_contiguous() or not p.is_cuda:
        raise ValueError('GEGLU kernel takes a contiguous bf16 CUDA tensor')
    if p.data_ptr() % 16:
        raise ValueError('GEGLU kernel takes a 16-byte aligned tensor')
    rows = p.numel() // (2 * inner)
    if rows * (inner // 8) >= 2 ** 31:
        raise ValueError(f'GEGLU kernel takes fewer than 2^31 output '
                         f'vectors, got {rows} rows of {inner}')
    out = p.new_empty(*p.shape[:-1], inner)
    err = _build.lib().star_geglu(p.data_ptr(), out.data_ptr(), rows, inner,
                                  _build.stream_ptr(p.device))
    _build.check(err, 'star_geglu')
    _contract.COUNTS['geglu'] += 1
    return out


_K12 = _contract.Kernel(__name__, '_launch', 'geglu_plain', recompute=True)


def geglu(p: torch.Tensor) -> torch.Tensor:
    """p [..., 2*inner] (h, then the gate) -> h * gelu_tanh(gate)
    [..., inner]. Differentiable (plain recompute backward)."""
    return _K12(p)
