"""CogVideoX-5B-based STAR super-resolution
(counterpart of star_tpu/pipeline/cogvideo_sr.py).

Per clip: T5 conditioning of the prompt and the negative prompt -> causal
3D VAE encode of the LQ frames (a posterior sample) -> 50 steps of
VPSDE-DPM++(2M) with DynamicCFG (scale 6, exponent 5) over the DiT on the
CFG pair (uncond first) with the LQ latent channel-concatenated -> serial
windowed decode (windows [0:3], then [2i+1:2i+3], each continuing the
causal convs of the previous one) -> AdaIN colour fix -> uint8.

Input: 4k+1 frames at the target resolution (720x480 for the published
model); the latents are [1, k+1, H/8, W/8, 16], k+1 odd.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..diffusion.vpsde_sampler import sample_vpsde_dpmpp_2m
from ..diffusion.zero_snr import ZeroSNRDDPMDiscretization
from ..models.conditioner import GeneralConditioner, TextEmbedder
from ..utils.device import resolve_device
from .color_fix import adain_color_fix


@dataclasses.dataclass
class CogModelBundle:
    """The networks the pipelines drive:
      dit(x [B, T, h, w, 2Cz] (Cz for the stock text-to-video DiT), t_idx
          [B], context [B, 226, 4096]) -> v
      vae.encode(video, generator, eps) -> scaled latents (SR only);
      vae.decode_window(latents, cache, first) -> (video, cache)
      text(tokens [B, 226]) -> [B, 226, 4096]
      tokenizer(texts) -> [B, 226] int32
    """
    dit: nn.Module
    vae: nn.Module
    text: nn.Module
    tokenizer: Any


@dataclasses.dataclass(frozen=True)
class CogSamplerConfig:
    num_steps: int = 50
    guider_scale: float = 6.0
    guider_exp: float = 5.0
    shift_scale: float = 1.0


def latent_frames(num_frames: int) -> int:
    """The latent frame count of `num_frames` frames; raises unless it is
    4k+1 with k+1 odd (the windowed decode drops the tail otherwise)."""
    t_lat = (num_frames - 1) // 4 + 1
    if (num_frames - 1) % 4 or (t_lat > 1 and t_lat % 2 == 0):
        raise ValueError(f'{num_frames} frames: the frame count must be 4k+1 '
                         'with k+1 odd (the windowed decode drops the tail '
                         'otherwise)')
    return t_lat


def cfg_denoiser(dit: nn.Module, ctx_pair: torch.Tensor,
                 lq_pair: torch.Tensor | None = None):
    """denoise_fn(x, t, a, scale) of the VPSDE sampler: `dit` on the CFG
    pair (uncond first, `ctx_pair`), with the LQ latents `lq_pair`
    channel-concatenated for SR and none for the stock model; VideoScaling
    (c_skip = a on the noise channels, c_out = -sqrt(1 - a^2), c_in = 1),
    then the DynamicCFG mix. The constants round to fp32 as the JAX
    package's do."""
    def denoise_fn(x, t, a, scale):
        xp = torch.cat([x, x], dim=0)
        xin = xp if lq_pair is None else torch.cat(
            [xp.to(lq_pair.dtype), lq_pair], dim=-1)
        v = dit(xin, torch.full((2,), t, device=x.device), ctx_pair).float()
        a32 = np.float32(a)
        c_out = float(-np.sqrt(np.float32(1.0) - a32 * a32))
        den = v * c_out + xp.float() * float(a32)
        d_u, d_c = den.chunk(2, dim=0)
        return d_u + float(np.float32(scale)) * (d_c - d_u)
    return denoise_fn


@torch.no_grad()
def decode_windows(vae: nn.Module, out_z: torch.Tensor) -> torch.Tensor:
    """Serial windowed decode of latents [1, T, h, w, Cz]: [0:3], then
    [2i+1:2i+3], each window continuing the causal convs of the one
    before."""
    t_lat = out_z.shape[1]
    if t_lat <= 3:
        return vae.decode_window(out_z, {}, True)[0]
    recons, cache = [], {}
    for i in range((t_lat - 1) // 2):
        s, e = (0, 3) if i == 0 else (2 * i + 1, 2 * i + 3)
        video, cache = vae.decode_window(out_z[:, s:e], cache, i == 0)
        recons.append(video)
    return torch.cat(recons, dim=1)


class CogPipelineBase:
    """What the CogVideoX pipelines share: the device, the ZeroSNR
    discretization, the T5 conditioning with its cache, and the stage
    timer. time_stages: synchronise the card after each stage and keep the
    host seconds of each in `stage_seconds`."""

    def __init__(self, models: CogModelBundle,
                 sampler: CogSamplerConfig = CogSamplerConfig(),
                 device: str | torch.device = 'cuda',
                 time_stages: bool = False):
        self.device = resolve_device(device)
        self.models = models
        self.cfg = sampler
        self.disc = ZeroSNRDDPMDiscretization(shift_scale=sampler.shift_scale)
        self.time_stages = time_stages
        self.stage_seconds: dict[str, float] = {}
        self.last_latents: torch.Tensor | None = None   # of the last solve
        self._text_cache: dict[str, torch.Tensor] = {}
        # one T5 crossattn embedder at inference; trainers add a ucg_rate
        self.conditioner = GeneralConditioner([
            TextEmbedder(input_key='txt', tokenizer=models.tokenizer,
                         encode=lambda tok: models.text(tok.to(self.device)))])

    def _stage(self, name: str, t0: float) -> float:
        if self.time_stages:
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            self.stage_seconds[name] = self.stage_seconds.get(name, 0.0) \
                + t1 - t0
            return t1
        return t0

    @torch.no_grad()
    def encode_prompt(self, prompt: str) -> torch.Tensor:
        if prompt not in self._text_cache:
            self._text_cache[prompt] = self.conditioner(
                {'txt': [prompt]})['crossattn']
        return self._text_cache[prompt]

    def _sample(self, denoise_fn, init: torch.Tensor,
                generator: torch.Generator | None,
                noises) -> torch.Tensor:
        return sample_vpsde_dpmpp_2m(
            denoise_fn, init.to(self.device, torch.float32), self.disc,
            self.cfg.num_steps, generator, self.cfg.guider_scale,
            self.cfg.guider_exp, noises=noises)


class CogVideoSRPipeline(CogPipelineBase):
    """Stage seconds: text, vae_encode, denoise, vae_decode, color_fix."""

    @torch.no_grad()
    def solve(self, video: torch.Tensor, ctx_c: torch.Tensor,
              ctx_u: torch.Tensor, generator: torch.Generator | None = None,
              noise: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
        """video [F, H, W, 3] in [-1, 1] on the device -> the denoised
        latents [1, T, H/8, W/8, Cz] (fp32). `noise` optionally injects
        'enc_eps' (the posterior sample), 'init' (the initial latent noise)
        and 'sde' (one tensor per step but the last) in place of draws from
        `generator`."""
        noise = noise or {}
        t0 = time.perf_counter()
        lq_z = self.models.vae.encode(video[None], generator,
                                      eps=noise.get('enc_eps'))
        t0 = self._stage('vae_encode', t0)
        denoise_fn = cfg_denoiser(self.models.dit,
                                  torch.cat([ctx_u, ctx_c], dim=0),
                                  torch.cat([lq_z, lq_z], dim=0))
        init = noise.get('init')
        if init is None:
            init = torch.randn(lq_z.shape, generator=generator,
                               device=self.device)
        out_z = self._sample(denoise_fn, init, generator, noise.get('sde'))
        self._stage('denoise', t0)
        return out_z

    def enhance_a_video(self, lq_frames: np.ndarray, prompt: str,
                        negative_prompt: str = '', seed: int = 42,
                        noise: Optional[Mapping[str, Any]] = None
                        ) -> np.ndarray:
        """lq_frames [F, H, W, 3] uint8 RGB, already at the target
        resolution -> [F, H, W, 3] uint8."""
        latent_frames(lq_frames.shape[0])
        self.stage_seconds = {}
        t0 = time.perf_counter()
        video = torch.as_tensor(lq_frames, device=self.device).float()
        video = (video / 255.0 - 0.5) / 0.5
        ctx_c = self.encode_prompt(prompt)
        ctx_u = self.encode_prompt(negative_prompt)
        self._stage('text', t0)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        out_z = self.solve(video, ctx_c, ctx_u, generator, noise)
        self.last_latents = out_z
        t0 = time.perf_counter()
        with torch.no_grad():
            out = decode_windows(self.models.vae, out_z)[0]
            t0 = self._stage('vae_decode', t0)
            out = torch.clamp(out.float() * 0.5 + 0.5, 0.0, 1.0) * 255.0
            out = torch.round(adain_color_fix(out, video)).to(torch.uint8)
        self._stage('color_fix', t0)
        return out.cpu().numpy()
