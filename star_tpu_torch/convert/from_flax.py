"""Carry a star_tpu parameter tree over to the port.

The port's module attribute names follow the JAX package's flax module
names, so a flax path 'a/b/kernel' lands on state_dict key 'a.b.weight'.
The leaf is rewritten by the kind of port module that owns it:

  Linear          Dense kernel [in, out]      -> weight [out, in]
  Conv2d          Conv kernel HWIO            -> weight OIHW
  Conv3d          Conv kernel DHWIO           -> weight OIDHW
  NormParams      GroupNorm/LayerNorm 'scale' -> weight ('bias' as is)
  TConvParams     (3, 1, Cin, Cout) kernel    -> weight, layout kept (K5's)
  anything else   a parameter of the same name (embeddings, mix_factor,
                  the DiT's loose LayerNorm parameters)

A scanned layer stack (flax `nn.scan`: 'layers/layer/...' with a leading
axis of the layer count) lands on an nn.ModuleList of the same name, layer
i taking slice i of every leaf.

Every flax leaf must land somewhere and every port parameter must be
found: a mismatch raises.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from ..models.layers import NormParams, TConvParams


def _leaves(tree: Mapping[str, Any], prefix: str = ''):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, f'{prefix}{k}/')
        else:
            yield f'{prefix}{k}'


def _index(tree: Mapping[str, Any], i: int, n: int) -> dict:
    """Slice i of every leaf of a scanned stack of n layers."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _index(v, i, n)
        elif np.shape(v)[0] != n:
            raise ValueError(f'{k}: a stack of {np.shape(v)[0]} layers for '
                             f'{n} port layers')
        else:
            out[k] = np.asarray(v)[i]
    return out


def from_flax(module: nn.Module, tree: Mapping[str, Any]
              ) -> dict[str, torch.Tensor]:
    """flax params (nested dicts of arrays; a lone top-level 'params' key is
    unwrapped) -> a state_dict for `module` (CPU float tensors)."""
    if set(tree) == {'params'}:
        tree = tree['params']
    sd: dict[str, torch.Tensor] = {}
    used: set[str] = set()

    def leaf(sub, path, name):
        used.add(path + name)
        return torch.from_numpy(np.array(sub[name], dtype=np.float32))

    def walk(mod: nn.Module, sub: Mapping[str, Any], path: str, key: str):
        if isinstance(mod, nn.Linear):
            sd[key + 'weight'] = leaf(sub, path, 'kernel').T.contiguous()
            if mod.bias is not None:
                sd[key + 'bias'] = leaf(sub, path, 'bias')
        elif isinstance(mod, (nn.Conv2d, nn.Conv3d)):
            kernel = leaf(sub, path, 'kernel')
            order = (3, 2, 0, 1) if kernel.ndim == 4 else (4, 3, 0, 1, 2)
            sd[key + 'weight'] = kernel.permute(*order).contiguous()
            if mod.bias is not None:
                sd[key + 'bias'] = leaf(sub, path, 'bias')
        elif isinstance(mod, NormParams):
            sd[key + 'weight'] = leaf(sub, path, 'scale')
            sd[key + 'bias'] = leaf(sub, path, 'bias')
        elif isinstance(mod, TConvParams):
            sd[key + 'weight'] = leaf(sub, path, 'kernel')
            sd[key + 'bias'] = leaf(sub, path, 'bias')
        else:
            for name, _ in mod.named_parameters(recurse=False):
                sd[key + name] = leaf(sub, path, name)
        for name, child in mod.named_children():
            if isinstance(child, nn.ModuleList):
                stack = sub[name]['layer']
                for i, layer in enumerate(child):
                    walk(layer, _index(stack, i, len(child)),
                         f'{path}{name}/layer/', f'{key}{name}.{i}.')
            else:
                walk(child, sub[name], f'{path}{name}/', f'{key}{name}.')

    walk(module, tree, '', '')
    unused = sorted(set(_leaves(tree)) - used)
    if unused:
        raise KeyError(f'flax leaves with no port parameter: {unused[:10]}')
    want = set(module.state_dict())
    if want != set(sd):
        raise KeyError(f'port parameters not found: '
                       f'{sorted(want - set(sd))[:10]}')
    for k, v in module.state_dict().items():
        if tuple(v.shape) != tuple(sd[k].shape):
            raise ValueError(f'{k}: port {tuple(v.shape)} vs flax '
                             f'{tuple(sd[k].shape)}')
    return sd


def load_flax(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Load a flax tree into `module` in place (keeping its device and
    dtype) and return it."""
    module.load_state_dict(from_flax(module, tree))
    return module
