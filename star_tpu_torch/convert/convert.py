"""Apply a name map to a reference torch state dict -> the state dict of a
port module; torch files in and out (counterpart of
star_tpu/convert/convert.py, with no flax tree in between and no orbax).

    sd = load_params('light_deg.pt')
    sd = convert_state_dict(sd, controlled_unet_name_map(), unet)
    save_params('weights/unet.pt', sd)

`unet` may live on the meta device: only its keys and shapes are read.
(video_to_video_model.py:37-40 loads the same dict with strict=False.)
"""

from __future__ import annotations

import pickle
import zipfile
from typing import Any, Dict, Mapping

import torch
from torch import nn

from .unet_map import NameMap


def nest(flat: Mapping[str, Any], sep: str = '/') -> Dict[str, Any]:
    """'a/b/c' keys -> nested dicts."""
    tree: Dict[str, Any] = {}
    for path, val in flat.items():
        parts = path.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def convert_state_dict(state_dict: Mapping[str, torch.Tensor],
                       name_map: NameMap, module: nn.Module,
                       strict: bool = True) -> Dict[str, torch.Tensor]:
    """-> the state dict of `module`, each tensor in the dtype and on the
    device it came in (a view of it where the layouts agree).

    Raises on reference keys the map needs and the dict lacks (unless
    strict=False: the result then lacks their parameters), on reference
    keys the map neither reads nor ignores, on a map that does not cover
    `module` exactly, and on a shape that is not the module's."""
    want = module.state_dict()
    if set(name_map) != set(want):
        raise KeyError(
            f'the name map does not fit {type(module).__name__}: '
            f'{sorted(set(want) - set(name_map))[:5]} not mapped, '
            f'{sorted(set(name_map) - set(want))[:5]} not in the module')
    out: Dict[str, torch.Tensor] = {}
    missing, misshapen = [], []
    for key, (src, fn) in name_map.items():
        if src not in state_dict:
            missing.append(src)
            continue
        t = state_dict[src]
        if fn is not None:
            t = fn(t)
        if tuple(t.shape) != tuple(want[key].shape):
            misshapen.append(f'{src} -> {key}: {tuple(t.shape)}, want '
                             f'{tuple(want[key].shape)}')
        out[key] = t
    read = {src for src, _ in name_map.values()}
    unused = sorted(k for k in state_dict
                    if k not in read and not name_map.ignores(k))
    if missing and strict:
        raise KeyError(f'{len(missing)} parameters missing from the state '
                       f'dict, first few: {missing[:5]}')
    if unused:
        raise KeyError(f'{len(unused)} keys of the state dict have no port '
                       f'parameter, first few: {unused[:5]}')
    if misshapen:
        raise ValueError(f'{len(misshapen)} shapes do not fit, first few: '
                         f'{misshapen[:5]}')
    return out


def save_params(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """torch.save of a flat state dict; a view is saved without the rest
    of the storage it lies in."""
    def own(t):
        t = t.detach()
        whole = t.untyped_storage().nbytes() == t.numel() * t.element_size()
        return t if whole and t.is_contiguous() else t.clone()
    torch.save({k: own(v) for k, v in state_dict.items()}, path)


def load_params(path: str, trust_pickle: bool = False) -> Dict[str, Any]:
    """torch.load onto the CPU, memory-mapped where the file's format
    allows. By default with weights_only=True (tensors and plain containers
    only); `trust_pickle` reads it with weights_only=False, as the JAX
    converter does, which runs whatever code the file's pickle names."""
    mmap = zipfile.is_zipfile(path)
    if trust_pickle:
        return torch.load(path, map_location='cpu', weights_only=False,
                          mmap=mmap)
    try:
        return torch.load(path, map_location='cpu', weights_only=True,
                          mmap=mmap)
    except pickle.UnpicklingError as e:
        # torch names what it refused on the line of its unpickler's error
        lines = [ln.strip() for ln in str(e).splitlines()]
        refused = [ln for ln in lines if 'Unpickler error' in ln] or lines[:1]
        raise ValueError(
            f'{path}: torch.load(weights_only=True) refused it: '
            f'{refused[0][:300]}; save its state dict with tensors and plain '
            'containers only, or convert it with --trust-pickle if you trust '
            'the file: that runs the code its pickle names') from e
