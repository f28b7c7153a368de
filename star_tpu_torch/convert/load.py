"""Load converted checkpoints into the port's model bundles
(counterpart of star_tpu/convert/load.py).

Layout on disk (written by convert/cli.py, one flat torch state dict each):
    {root}/unet.pt        ControlledV2VUNet (unet.* and controlnet.*)
    {root}/vae.pt         SVDTemporalVAE
    {root}/clip.pt        CLIPTextEncoder
    {root}/dit.pt         CogVideoDiT (CogVideoX SR; or the stock
                          text-to-video DiT, liem=False, a state dict the
                          port wrote: no converter reads a stock checkpoint)
    {root}/t5.pt          T5Encoder (T5-XXL)
    {root}/causal_vae.pt  CogVideoVAE

Conversion (where the reference checkpoints live; no card needed):
    python -m star_tpu_torch.convert.cli unet light_deg.pt out/unet.pt
    python -m star_tpu_torch.convert.cli vae  svd_vae.bin  out/vae.pt
    python -m star_tpu_torch.convert.cli clip open_clip_pytorch_model.bin \
        out/clip.pt

A model is built on the meta device (no memory) and takes the file's
tensors, memory-mapped and moved to the device one at a time, so neither
host nor card holds a second copy.
"""

from __future__ import annotations

import os
from typing import Callable

import torch
from torch import nn

from ..models.clip.text import CLIPTextEncoder
from ..models.dit.dit import CogVideoDiT
from ..models.t5.encoder import T5Encoder
from ..models.unet.unet import ControlledV2VUNet
from ..pipeline.build import CogModels, StarModels
from ..utils.device import resolve_device
from ..vae.causal_vae import CogVideoVAE
from ..vae.svd_vae import SVDTemporalVAE
from .causal_vae_map import causal_vae_name_map
from .convert import load_params
from .tower_maps import (clip_text_name_map, dit_name_map, svd_vae_name_map,
                         t5_encoder_name_map)
from .unet_map import NameMap, controlled_unet_name_map

KINDS = ('unet', 'vae', 'clip', 't5', 'dit', 'causal_vae')


def tower(kind: str, num_layers: int | None = None, liem: bool = True
          ) -> tuple[Callable[[], nn.Module], NameMap | None]:
    """(constructor of the port module, name map) of one checkpoint kind
    at its published size; `num_layers` cuts the depth of clip, t5 and
    dit. liem=False gives the stock text-to-video DiT, whose files the
    port writes itself: no name map reads a stock checkpoint (None)."""
    if kind == 'unet':
        return ControlledV2VUNet, controlled_unet_name_map()
    if kind == 'vae':
        return SVDTemporalVAE, svd_vae_name_map()
    if kind == 'clip':
        n = num_layers or 24
        return (lambda: CLIPTextEncoder(layers=n),
                clip_text_name_map(layers=n))
    if kind == 't5':
        n = num_layers or 24
        return (lambda: T5Encoder(num_layers=n),
                t5_encoder_name_map(num_layers=n))
    if kind == 'dit':
        n = num_layers or 42
        return (lambda: CogVideoDiT(num_layers=n, liem=liem),
                dit_name_map(num_layers=n) if liem else None)
    if kind == 'causal_vae':
        return CogVideoVAE, causal_vae_name_map()
    raise ValueError(f'unknown checkpoint kind {kind!r}; one of {KINDS}')


def on_meta(build: Callable[[], nn.Module]) -> nn.Module:
    with torch.device('meta'):
        return build()


def module_from_state_dict(build: Callable[[], nn.Module], state_dict,
                           dtype: torch.dtype, device: torch.device
                           ) -> nn.Module:
    """build() on the meta device, then each tensor of `state_dict` moved
    to `device` and cast to `dtype` in place of its parameter (eval mode,
    no grad). Every parameter must be given."""
    model = on_meta(build)
    sd = {k: v.to(device).to(dtype) if v.is_floating_point()
          else v.to(device) for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def load_tower(root: str, kind: str, dtype: torch.dtype,
               device: torch.device, liem: bool = True) -> nn.Module:
    """{root}/{kind}.pt into the kind's module, strictly: a missing,
    unexpected or misshapen key raises."""
    build, _ = tower(kind, liem=liem)
    return module_from_state_dict(
        build, load_params(os.path.join(root, f'{kind}.pt')), dtype, device)


def load_star_models(root: str, dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device = 'cuda') -> StarModels:
    """The I2VGen-XL towers (unet.pt, vae.pt, clip.pt) on `device`."""
    dev = resolve_device(device)
    return StarModels(*(load_tower(root, k, dtype, dev)
                        for k in ('unet', 'vae', 'clip')))


def load_cog_models(root: str, dtype: torch.dtype = torch.bfloat16,
                    device: str | torch.device = 'cuda',
                    liem: bool = True) -> CogModels:
    """The CogVideoX towers (dit.pt, causal_vae.pt, t5.pt) on `device`: the
    SR DiT, or with liem=False the stock text-to-video DiT. A dit.pt of the
    other form fails to load, naming its extra or missing LIEM keys."""
    dev = resolve_device(device)
    return CogModels(*(load_tower(root, k, dtype, dev, liem)
                       for k in ('dit', 'causal_vae', 't5')))
