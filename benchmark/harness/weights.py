"""Seeded random weights, made on the device in one call and handed to
the program and, cast to float32, to the reference.

Every parameter is a nonzero draw (the program's zero-initialised heads
and zero convs too, so that every path carries signal): a product's
weight N(0, 1/fan_in), a bias N(0, 0.02^2), a norm's scale 1 + N(0, 0.1^2),
an embedding N(0, 0.02^2), a blend factor N(0, 1). T5's query is drawn
as T5 draws it, N(0, 1/(d_model d_kv)): T5 does not scale its logits, and
at 1/d_model they would spread by sqrt(d_kv), so peaked that rounding
alone would decide each softmax."""

from __future__ import annotations

import torch
from torch import nn

TCONV_TYPES = ('TConvParams',)   # weight [3, 1, Cin, Cout]
T5_BLOCK_TYPES = ('T5Block',)    # its `q` takes T5's own scale
# each parameter starts 256 bytes (bf16) into the draw's buffer after the
# last: the kernels take aligned rows
ALIGN = 128


def _rule(mod: nn.Module, leaf: str, shape) -> tuple[str, float]:
    """('normal', std) or ('unit', std): how to scale a standard draw."""
    if leaf.endswith('bias'):
        return 'normal', 0.02
    if len(shape) == 1:
        if leaf == 'mix_factor':
            return 'normal', 1.0
        return 'unit', 0.1
    if 'embedding' in leaf:
        return 'normal', 0.02
    if type(mod).__name__ in TCONV_TYPES:
        fan_in = shape[0] * shape[1] * shape[2]
    else:
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
    return 'normal', fan_in ** -0.5


def _aligned(n: int, step: int = ALIGN) -> int:
    return -(-n // step) * step


def make_weights(model: nn.Module, seed: int, device, dtype=torch.bfloat16,
                 prefix: str = '') -> dict[str, torch.Tensor]:
    """A state dict for `model` (on any device, meta included): one
    standard draw for all parameters from `seed`, scaled leaf by leaf,
    each leaf an aligned view of the draw."""
    mods = dict(model.named_modules())
    names = [(n, p.shape) for n, p in model.named_parameters()]
    total = sum(_aligned(s.numel()) for _, s in names)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    sd, off = {}, 0
    with torch.no_grad():
        for name, shape in names:
            owner, _, leaf = name.rpartition('.')
            t = flat[off:off + shape.numel()].view(shape)
            off += _aligned(shape.numel())
            kind, std = _rule(mods[owner], leaf, shape)
            parent, _, child = owner.rpartition('.')
            if child == 'q' and type(mods.get(parent)).__name__ in \
                    T5_BLOCK_TYPES:
                std *= (shape[0] // mods[parent].num_heads) ** -0.5
            t.mul_(std)
            if kind == 'unit':
                t.add_(1.0)
            sd[prefix + name] = t
    return sd


def assign(model: nn.Module, sd: dict, prefix: str = '') -> nn.Module:
    """Load `sd` into `model` without copying (the model's parameters
    become the state dict's tensors)."""
    own = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    model.load_state_dict(own, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def to_float32(sd: dict, prefix: str = '') -> dict[str, torch.Tensor]:
    return {k: v.float() for k, v in sd.items() if k.startswith(prefix)}
