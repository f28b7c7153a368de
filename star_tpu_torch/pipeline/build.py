"""Assemble the full pipelines (counterpart of star_tpu/pipeline/build.py
and of the model construction in star_tpu/cli/sample_sr.py).

init_random_models builds the full-size CLIP text tower, UNet+ControlNet
and SVD VAE, and init_random_cog_models the CogVideoX DiT, T5-XXL encoder
and causal 3D VAE, directly on the device, and initialises them from a seed
the way the flax modules initialise (normal weights with std
1/sqrt(fan_in), zero biases, unit norms, zero-init heads and zero convs),
so every shape, dtype and kernel is the real one and the outputs are
meaningless. Weights carried over from the JAX package load through
convert/from_flax.py instead.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..config import PipelineConfig
from ..models.clip.text import CLIPTextEncoder
from ..models.clip.tokenizer import default_tokenizer
from ..models.dit.dit import CogVideoDiT
from ..models.layers import NormParams, TConvParams
from ..models.t5.encoder import T5Encoder
from ..models.t5.tokenizer import default_t5_tokenizer
from ..models.unet.unet import ControlledV2VUNet
from ..utils.device import resolve_device
from ..vae.causal_vae import CogVideoVAE
from ..vae.svd_vae import SVDTemporalVAE, SpatioTemporalResBlock
from .cogvideo_sr import CogModelBundle, CogSamplerConfig, CogVideoSRPipeline
from .video_sr import ModelBundle, STARPipeline


@dataclasses.dataclass
class StarModels:
    unet: ControlledV2VUNet
    vae: SVDTemporalVAE
    text: CLIPTextEncoder


@dataclasses.dataclass
class CogModels:
    dit: CogVideoDiT
    vae: CogVideoVAE
    text: T5Encoder


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise `model` in place from `generator` with the flax
    modules' initialisers."""
    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32) * std)

    for mod in model.modules():
        if getattr(mod, 'zero_init', False):
            for p in mod.parameters(recurse=False):
                p.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            fan_in = mod.weight[0].numel()
            normal_(mod.weight, 1.0 / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, TConvParams):
            normal_(mod.weight, 1.0 / math.sqrt(3 * mod.weight.shape[2]))
            mod.bias.zero_()
        elif isinstance(mod, NormParams):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, SpatioTemporalResBlock):
            mod.mix_factor.fill_(0.5)
        elif isinstance(mod, CLIPTextEncoder):
            normal_(mod.token_embedding, 0.02)
            normal_(mod.positional_embedding, 0.01)
        elif isinstance(mod, T5Encoder):
            normal_(mod.token_embedding, 1.0)
            normal_(mod.relative_attention_bias, 0.1)


def _init_random(builders, seed: int, dtype: torch.dtype,
                 device: str | torch.device) -> list[nn.Module]:
    """Build each model on `device` in fp32, initialise it from one seeded
    generator, then cast it to `dtype` (one model at a time, so the fp32
    copy of only one is alive)."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    models = []
    with torch.device(dev):
        for build in builders:
            m = build()
            init_like_flax(m, generator)
            models.append(m.to(dtype).eval().requires_grad_(False))
    return models


def init_random_models(seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                       device: str | torch.device = 'cuda',
                       vae_decode_window: int = 3) -> StarModels:
    """Random-weight full-size models on `device`, in `dtype`."""
    return StarModels(*_init_random(
        (ControlledV2VUNet,
         lambda: SVDTemporalVAE(decode_window=vae_decode_window),
         CLIPTextEncoder), seed, dtype, device))


def init_random_cog_models(seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                           device: str | torch.device = 'cuda',
                           liem: bool = True) -> CogModels:
    """Random-weight CogVideoX models at their published sizes (the
    42-layer DiT, the causal VAE, T5-XXL) on `device`, in `dtype`: the SR
    DiT (LIEM, 32 input channels), or with liem=False the stock
    text-to-video DiT (16 input channels)."""
    return CogModels(*_init_random(
        (lambda: CogVideoDiT(liem=liem), CogVideoVAE, T5Encoder), seed,
        dtype, device))


def make_bundle(models: StarModels, tokenizer=None, param_dtype=None,
                allow_hash_tokenizer: bool = False) -> ModelBundle:
    """param_dtype=torch.bfloat16 casts every weight (halves their memory
    for inference). Without a real BPE asset this raises unless
    allow_hash_tokenizer=True (smoke and benchmark runs)."""
    tokenizer = tokenizer or default_tokenizer(
        allow_fallback=allow_hash_tokenizer)
    nets = [models.unet, models.vae, models.text]
    if param_dtype is not None:
        nets = [m.to(param_dtype) for m in nets]
    return ModelBundle(*nets, tokenizer=tokenizer)


def build_pipeline(models: StarModels,
                   config: PipelineConfig = PipelineConfig(),
                   tokenizer=None, param_dtype=None,
                   allow_hash_tokenizer: bool = False,
                   device: str | torch.device = 'cuda') -> STARPipeline:
    return STARPipeline(make_bundle(models, tokenizer, param_dtype,
                                    allow_hash_tokenizer), config,
                        device=device)


def build_cog_pipeline(models: CogModels,
                       sampler: CogSamplerConfig = CogSamplerConfig(),
                       tokenizer=None, allow_hash_tokenizer: bool = False,
                       device: str | torch.device = 'cuda',
                       time_stages: bool = False) -> CogVideoSRPipeline:
    """The CogVideoX SR pipeline over `models`. Without the T5
    sentencepiece asset this raises unless allow_hash_tokenizer=True
    (random-weight runs)."""
    tokenizer = tokenizer or default_t5_tokenizer(
        allow_fallback=allow_hash_tokenizer)
    bundle = CogModelBundle(models.dit, models.vae, models.text, tokenizer)
    return CogVideoSRPipeline(bundle, sampler, device=device,
                              time_stages=time_stages)
