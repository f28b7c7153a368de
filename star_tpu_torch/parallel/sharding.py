"""Megatron tensor parallelism from the JAX package's rule table
(counterpart of star_tpu/parallel/sharding.py).

TP_RULES and spec_for_path are the JAX table over flax parameter paths;
a port parameter's path is its name with '.' -> '/' and its leaf 'weight'
-> 'kernel' (the rules name only kernels and biases of dense layers), so
param_specs gives JAX's spec, in the flax [in, out] layout, for every
parameter of the UNet+ControlNet, the DiT, CLIP and T5.

In JAX the table is a storage annotation and XLA makes any layout
correct. Here each rank's arithmetic must be local, so shard_params turns
the table into a storage plan of column- and row-parallel layers, one
attention or MLP at a time:

  * a column-parallel layer keeps its rank's output features (the
    input's gradient is all-reduced over 'tensor' in the backward), a
    row-parallel one its input features (its output is all-reduced over
    'tensor', then the bias added);
  * an attention's column shard holds whole heads: an attention whose head
    count the tensor size does not divide stays replicated, its output
    projection with it (the I2VGen UNet's 5 heads of 64 at 320 channels);
  * GEGLU's ff/proj shards its value and gate halves each, the DiT's
    fused qkv its q, k and v blocks each, by heads;
  * LoRA: the qkv's lora_a stays whole and its lora_b is split by output
    rows with the base; the dense's lora_a is split by input rows (its
    partial products all-reduced) and its lora_b stays whole. The JAX
    table splits qkv's lora_a over the rank r and dense's lora_b over its
    input: the same function, another layout.

shard_params shards the towers the training CLIs shard, the UNet+
ControlNet and the DiT; the text towers' layers stay replicated (no CLI of
either package shards them). The attention modules keep their local head
count in `num_heads`, so the kernels see [B, S, (H/P)*64].
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import AXIS_TENSOR, Mesh, P, collective

# (path regex, spec for kernel). Dense kernels are [in, out]; Conv kernels
# are [kh, kw, in, out]. Biases follow the output dim of their layer.
TP_RULES: Sequence[Tuple[str, P]] = (
    (r'(to_q|to_k|to_v|in_proj)/kernel$', P(None, AXIS_TENSOR)),
    (r'(to_q|to_k|to_v|in_proj)/bias$', P(AXIS_TENSOR)),
    (r'qkv/(base|lora_a)/kernel$', P(None, AXIS_TENSOR)),
    (r'qkv/base/bias$', P(AXIS_TENSOR)),
    (r'(^|/)(q|k|v)/kernel$', P(None, AXIS_TENSOR)),
    (r'(to_out|out_proj)/kernel$', P(AXIS_TENSOR, None)),
    (r'dense/(base|lora_b)/kernel$', P(AXIS_TENSOR, None)),
    (r'(^|/)o/kernel$', P(AXIS_TENSOR, None)),
    (r'(ff/proj|mlp_fc|wi_0|wi_1)/kernel$', P(None, AXIS_TENSOR)),
    (r'(ff/proj|mlp_fc)/bias$', P(AXIS_TENSOR)),
    (r'(ff/out|mlp_proj|(^|/)wo)/kernel$', P(AXIS_TENSOR, None)),
)


def spec_for_path(path: str) -> P:
    for pat, spec in TP_RULES:
        if re.search(pat, path):
            return spec
    return P()  # replicate


def flax_path(name: str) -> str:
    """The flax path of a port parameter name, as the rules read it."""
    parts = name.split('.')
    if parts[-1] == 'weight':
        parts[-1] = 'kernel'
    return '/'.join(parts)


# ---------------------------------------------------------- the Megatron ops


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group (the
    input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        collective(g, ctx.group)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward (the output of a row-parallel layer); identity
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        collective(x, group)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromTP.apply(x, group)


def take_blocks(t: torch.Tensor, dim: int, blocks: int, rank: int,
                n: int) -> torch.Tensor:
    """Rank `rank` of n's part of each of `blocks` equal blocks along dim,
    concatenated."""
    return torch.cat([b.chunk(n, dim)[rank] for b in t.chunk(blocks, dim)],
                     dim)


def join_blocks(parts: Sequence[torch.Tensor], dim: int,
                blocks: int) -> torch.Tensor:
    """The inverse of take_blocks over every rank's part (rank order)."""
    split = [p.chunk(blocks, dim) for p in parts]
    return torch.cat([torch.cat([s[i] for s in split], dim)
                      for i in range(blocks)], dim)


class ColumnParallelLinear(nn.Linear):
    """nn.Linear holding its rank's output features (`blocks` blocks split
    alike)."""

    def forward(self, x):
        return F.linear(copy_to_tp(x, self.tp_group), self.weight, self.bias)


class RowParallelLinear(nn.Linear):
    """nn.Linear holding its rank's input features; the partial products
    are all-reduced, then the bias added once."""

    def forward(self, x):
        y = reduce_from_tp(F.linear(x, self.weight), self.tp_group)
        return y if self.bias is None else y + self.bias


def _parallel(lin: nn.Linear, cls, group, rank: int, n: int,
              blocks: int = 1) -> nn.Linear:
    col = cls is ColumnParallelLinear
    w = lin.weight.detach()
    w = take_blocks(w, 0, blocks, rank, n) if col else w.chunk(n, 1)[rank]
    out = cls(w.shape[1], w.shape[0], bias=lin.bias is not None,
              device=w.device, dtype=w.dtype)
    with torch.no_grad():
        out.weight.copy_(w)
        if lin.bias is not None:
            b = lin.bias.detach()
            out.bias.copy_(take_blocks(b, 0, blocks, rank, n) if col else b)
    out.weight.requires_grad_(lin.weight.requires_grad)
    if lin.bias is not None:
        out.bias.requires_grad_(lin.bias.requires_grad)
    out.tp_group = group
    return out


# ------------------------------------------------------------ the storage plan


def _groups(model: nn.Module, n: int):
    """(module name, module, kind, divisible) of every attention and MLP
    that shard_params would split at tensor size n."""
    from ..models.dit.dit import DiTLayer
    from ..models.unet.blocks import (Attention, FeedForwardGEGLU,
                                      TemporalAttentionInplace)
    for name, mod in model.named_modules():
        if isinstance(mod, (Attention, TemporalAttentionInplace)):
            yield name, mod, 'attention', mod.num_heads % n == 0
        elif isinstance(mod, FeedForwardGEGLU):
            yield name, mod, 'geglu', mod.out.in_features % n == 0
        elif isinstance(mod, DiTLayer):
            yield name, mod, 'dit_attention', mod.num_heads % n == 0
            yield name, mod, 'dit_mlp', mod.mlp_proj.in_features % n == 0


# parameter (relative to its group's module) -> (torch dim, blocks)
_LAYOUT = {
    'attention': {'to_q.weight': (0, 1), 'to_k.weight': (0, 1),
                  'to_v.weight': (0, 1), 'to_out.weight': (1, 1)},
    'geglu': {'proj.weight': (0, 2), 'proj.bias': (0, 2),
              'out.weight': (1, 1)},
    'dit_attention': {'qkv.base.weight': (0, 3), 'qkv.base.bias': (0, 3),
                      'qkv.lora_b.weight': (0, 3),
                      'dense.base.weight': (1, 1),
                      'dense.lora_a.weight': (1, 1)},
    'dit_mlp': {'mlp_fc.weight': (0, 1), 'mlp_fc.bias': (0, 1),
                'mlp_proj.weight': (1, 1)},
}


def tp_plan(model: nn.Module, n: int) -> dict[str, tuple[int, int]]:
    """Parameter name -> (torch dim, blocks) of every parameter that
    shard_params splits at tensor size n (of the model before it is
    split)."""
    names = {n for n, _ in model.named_parameters()}
    plan = {}
    for name, _, kind, divisible in _groups(model, n):
        if divisible and n > 1:
            for rel, layout in _LAYOUT[kind].items():
                full = f'{name}.{rel}' if name else rel
                if full in names:
                    plan[full] = layout
    return plan


def param_specs(model: nn.Module, tensor: Optional[int] = None
                ) -> dict[str, P]:
    """Parameter name -> JAX's spec (flax [in, out] layout) from the rule
    table; with `tensor`, the storage spec of shard_params at that size in
    the same layout: P() for every parameter it keeps whole (a layer whose
    head count `tensor` does not divide, the text towers, the LoRA factors
    noted above)."""
    names = [n for n, _ in model.named_parameters()]
    if tensor is None:
        return {n: spec_for_path(flax_path(n)) for n in names}
    plan = tp_plan(model, tensor)
    out = {}
    for n in names:
        if n not in plan:
            out[n] = P()
        elif n.endswith('bias'):
            out[n] = P(AXIS_TENSOR)
        else:   # torch dim 0 (output) is the flax kernel's last dim
            out[n] = P(None, AXIS_TENSOR) if plan[n][0] == 0 \
                else P(AXIS_TENSOR, None)
    return out


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Split `model` in place over the mesh's 'tensor' axis (a no-op at
    one rank) and record the plan and the mesh as model.tp_plan and
    model.tp_mesh; returns the model."""
    n = mesh.size(AXIS_TENSOR)
    model.tp_plan, model.tp_mesh = tp_plan(model, n), mesh
    if n == 1:
        return model
    group, r = mesh.group(AXIS_TENSOR), mesh.index(AXIS_TENSOR)
    col = lambda lin, blocks=1: _parallel(lin, ColumnParallelLinear, group,
                                          r, n, blocks)
    row = lambda lin: _parallel(lin, RowParallelLinear, group, r, n)
    for _, mod, kind, divisible in list(_groups(model, n)):
        if not divisible:
            continue
        if kind == 'attention':
            for a in ('to_q', 'to_k', 'to_v'):
                setattr(mod, a, col(getattr(mod, a)))
            mod.to_out = row(mod.to_out)
            mod.num_heads //= n
        elif kind == 'geglu':
            mod.proj, mod.out = col(mod.proj, 2), row(mod.out)
        elif kind == 'dit_attention':
            qkv, dense = mod.qkv, mod.dense
            qkv.base = col(qkv.base, 3)
            if qkv.lora_rank:
                qkv.lora_b = col(qkv.lora_b, 3)
            dense.base = row(dense.base)
            if dense.lora_rank:
                dense.lora_a = row(dense.lora_a)
            qkv.tp_group = dense.tp_group = group
            qkv.tp_mode, dense.tp_mode = 'column', 'row'
            mod.num_heads //= n
        else:
            mod.mlp_fc, mod.mlp_proj = col(mod.mlp_fc), row(mod.mlp_proj)
    return model


def unshard(name: str, local: torch.Tensor, plan: dict, mesh: Mesh
            ) -> torch.Tensor:
    """The whole parameter (or a tensor laid out as it, such as an AdamW
    moment) from every tensor rank's part; a replicated one as it is."""
    if name not in plan or mesh.size(AXIS_TENSOR) == 1:
        return local
    dim, blocks = plan[name]
    g = mesh.group(AXIS_TENSOR)
    local = local.contiguous()
    collective(local, g)
    parts = [torch.empty_like(local) for _ in range(mesh.size(AXIS_TENSOR))]
    dist.all_gather(parts, local, group=g)
    return join_blocks(parts, dim, blocks)


def shard(name: str, full: torch.Tensor, plan: dict, mesh: Mesh
          ) -> torch.Tensor:
    """This tensor rank's part of a whole parameter (the inverse of
    unshard)."""
    if name not in plan or mesh.size(AXIS_TENSOR) == 1:
        return full
    dim, blocks = plan[name]
    return take_blocks(full, dim, blocks, mesh.index(AXIS_TENSOR),
                       mesh.size(AXIS_TENSOR)).contiguous()
