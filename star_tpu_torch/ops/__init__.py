"""Operators of the port. Each kernel module holds its kernels' launch
plans, launchers (the one function that calls a CUDA entry point), plain
PyTorch versions and a declaration under the one kernel contract
(`_contract.py`):

  * a CUDA tensor launches the kernel, or the launcher raises on what the
    kernel does not take; no launcher falls back to a plain version;
  * a CPU tensor runs the plain version, under grad too, where autograd
    differentiates it as any PyTorch code;
  * under grad, a CUDA tensor's backward is declared: a backward kernel in
    an autograd.Function of the module (K1/K2-d64: K2 `with_l` then K3;
    K9; these two also run on the CPU, with the backward kernels' plain
    versions), the plain version recomputed inside the backward
    (`Kernel(..., recompute=True)`: K4, K5, K10, K11, K12, K13), or a
    refusal by the launcher (K2 d=512, K6, K7, K8);
  * each launcher adds one to the counter `_contract.COUNTS` under a name
    its module declares (`_contract.kernels`): `launch_counts()`.

  flash_attention       K1 (packed, d=64), K2 (d=512; and `with_l`, the
                        d=64 training forward that writes the lse), K3
  temporal_attention    K4
  fused_temporal_conv   K5
  conv3x3               K6 (fused GN + SiLU + 3x3 conv)
  upsample_conv         K7 (fused nearest-2x + 3x3 conv), K8 (2x2 interleave)
  qk_ln_rope            K9 (fused qk-LayerNorm + RoPE) and its backward
  fused_ln              K10 (LayerNorm, optionally LIEM-gated), K11
                        (residual add + [LIEM gate +] LayerNorm)
  geglu                 K12 (the UNet's GEGLU)
  norms                 K13 (GroupNorm: statistics, then the apply with the
                        SiLU optionally fused), and the GroupNorm statistics
                        K5-K8 thread (`channel_stats`, `gn_coeffs`)

K6 and K7 are routed by width, as in the JAX package: on the card, widths
their tiles do not divide run the plain convolutions.

flash_attention is the one module that writes its CUDA/CPU branch out (in
`flash_attention`, `flash_attention_packed` and `_FlashAttentionD64`)
rather than declaring a `Kernel`: its launchers take the head width and
the softmax scale folded with log2(e), its plain versions the natural
scale (with a `prescaled` flag), and K3's plain version only the valid
keys, so no one argument list serves a launcher and its plain version.
"""

from . import (_contract, conv3x3, flash_attention, fused_ln,
               fused_temporal_conv, geglu, norms, qk_ln_rope,
               temporal_attention, upsample_conv)

KERNELS = tuple(_contract.COUNTS)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset_launch_counts()."""
    return dict(_contract.COUNTS)


def reset_launch_counts() -> None:
    """Zero every launch count, and K9's count of backward calls."""
    _contract.COUNTS.update(dict.fromkeys(_contract.COUNTS, 0))
    qk_ln_rope.BACKWARDS = 0
