"""Stock CogVideoX text-to-video sampling, not SR
(counterpart of star_tpu/pipeline/cogvideo_t2v.py).

Behavioral reference: cogvideox-based/inference/cli_demo.py, the T2V demo
the reference ships beside the SR pipeline: prompt -> T5 encode -> 50-step
guided sampling from pure noise -> causal 3D VAE decode. 4k+1 frames (49
by default) of 480x720, guidance 6.

It reuses the SR stack with the stock model's differences: the DiT is
CogVideoDiT(liem=False) on 16 latent channels (no LQ concat), with the same
ZeroSNR discretization, VPSDE-DPM++(2M) solver with DynamicCFG and serial
windowed decode. There is no colour fix. The bundle's vae.encode is unused.
"""

from __future__ import annotations

import time
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .cogvideo_sr import (CogModelBundle, CogPipelineBase, CogSamplerConfig,
                          cfg_denoiser, decode_windows, latent_frames)


class CogVideoT2VPipeline(CogPipelineBase):
    """Text -> video with the stock DiT. Stage seconds: text, denoise,
    vae_decode."""

    def __init__(self, models: CogModelBundle,
                 sampler: CogSamplerConfig = CogSamplerConfig(),
                 latent_hw: tuple[int, int] = (60, 90),
                 latent_channels: int = 16,
                 device: str | torch.device = 'cuda',
                 time_stages: bool = False):
        super().__init__(models, sampler, device, time_stages)
        self.latent_hw = latent_hw
        self.latent_channels = latent_channels

    @torch.no_grad()
    def solve(self, ctx_c: torch.Tensor, ctx_u: torch.Tensor, t_lat: int,
              generator: torch.Generator | None = None,
              noise: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
        """The denoised latents [1, t_lat, h, w, Cz] (fp32) from pure noise.
        `noise` optionally injects 'init' (the initial latent noise) and
        'sde' (one tensor per step but the last) in place of draws from
        `generator`."""
        noise = noise or {}
        t0 = time.perf_counter()
        init = noise.get('init')
        if init is None:
            init = torch.randn((1, t_lat, *self.latent_hw,
                                self.latent_channels), generator=generator,
                               device=self.device)
        denoise_fn = cfg_denoiser(self.models.dit,
                                  torch.cat([ctx_u, ctx_c], dim=0))
        out_z = self._sample(denoise_fn, init, generator, noise.get('sde'))
        self._stage('denoise', t0)
        return out_z

    def sample(self, prompt: str, num_frames: int = 49,
               negative_prompt: str = '', seed: int = 42,
               noise: Optional[Mapping[str, Any]] = None) -> np.ndarray:
        """prompt -> [num_frames, 8h, 8w, 3] uint8 (cli_demo.py's
        defaults)."""
        t_lat = latent_frames(num_frames)
        self.stage_seconds = {}
        t0 = time.perf_counter()
        ctx_c = self.encode_prompt(prompt)
        ctx_u = self.encode_prompt(negative_prompt)
        self._stage('text', t0)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        out_z = self.solve(ctx_c, ctx_u, t_lat, generator, noise)
        self.last_latents = out_z
        t0 = time.perf_counter()
        with torch.no_grad():
            out = decode_windows(self.models.vae, out_z)[0]
            out = torch.round(torch.clamp(out.float() * 0.5 + 0.5, 0.0, 1.0)
                              * 255.0).to(torch.uint8)
        self._stage('vae_decode', t0)
        return out.cpu().numpy()
