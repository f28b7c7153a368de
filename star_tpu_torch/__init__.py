"""PyTorch / H100 port of star_tpu (STAR video super-resolution).

The JAX package star_tpu stays the reference; this package imports torch
and numpy and nothing of JAX or star_tpu. Entry points run on the CUDA card
unless given device="cpu"; on the card the hot operators run hand-written
CUDA kernels (csrc/), on the CPU their plain PyTorch versions.
"""
