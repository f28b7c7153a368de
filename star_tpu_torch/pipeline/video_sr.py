"""End-to-end I2VGen-XL video super-resolution
(counterpart of star_tpu/pipeline/video_sr.py).

enhance_a_video: x4 bilinear upsample and pad to the latent grid, SVD-VAE
encode (posterior sample), SDEdit diffuse to t=899, chunked CFG denoising
with DPM++(2M)-SDE over UNet+ControlNet (cfg_pair shares the y-independent
prefix), windowed temporal VAE decode, unpad, AdaIN colour fix, and the
uint8 result made on the card. Solve and decode are separate steps; the
latents stay on the device between them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import PipelineConfig
from ..diffusion import (DiffusionTables, Schedule, build_sigma_ladder,
                         default_star_schedule, denoise_to_x0, diffuse,
                         sample_dpmpp_2m_sde, sample_heun)
from ..ops.resize import pad_to_fit, resize_bilinear
from ..utils.device import resolve_device
from .chunking import chunked_x0_fn, make_chunks
from .color_fix import adain_color_fix, wavelet_color_fix


@dataclasses.dataclass
class ModelBundle:
    """The networks the pipeline drives:
      unet(x, t, y, hint, cfg_pair=...) -> v     [B, F, h, w, 4] latents
      vae.encode(video, generator, eps) -> latents; vae.decode(z) -> video
      text(tokens [B, 77]) -> y [B, 77, 1024]
    """
    unet: nn.Module
    vae: nn.Module
    text: nn.Module
    tokenizer: Any


class STARPipeline:
    """PyTorch counterpart of the JAX STARPipeline.

    time_stages: synchronise the card after each stage and keep the host
    seconds of each in `stage_seconds` (for measurement runs)."""

    def __init__(self, models: ModelBundle,
                 config: PipelineConfig = PipelineConfig(),
                 schedule: Optional[Schedule] = None,
                 device: str | torch.device = 'cuda',
                 time_stages: bool = False, mesh=None):
        """mesh: an optional parallel.Mesh; the solver's independent chunk
        windows are split over its 'data' axis (chunked_x0_fn)."""
        self.device = resolve_device(device)
        self.mesh = mesh
        self.models = models
        self.cfg = config
        self.schedule = schedule or default_star_schedule()
        self.tables = DiffusionTables.from_schedule(self.schedule,
                                                    self.device)
        self.time_stages = time_stages
        self.stage_seconds: dict[str, float] = {}
        self._text_cache: dict[str, torch.Tensor] = {}
        self.last_latents: torch.Tensor | None = None   # of the last solve

    def _stage(self, name: str, t0: float) -> float:
        if self.time_stages:
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            self.stage_seconds[name] = self.stage_seconds.get(name, 0.0) \
                + t1 - t0
            return t1
        return t0

    # ------------------------------------------------------------------ text
    @torch.no_grad()
    def encode_prompt(self, prompt: str) -> torch.Tensor:
        if prompt not in self._text_cache:
            tokens = torch.as_tensor(self.models.tokenizer([prompt]),
                                     device=self.device)
            self._text_cache[prompt] = self.models.text(tokens)
        return self._text_cache[prompt]

    # ----------------------------------------------------------------- steps
    def _padding(self, target_h: int, target_w: int):
        return pad_to_fit(target_h, target_w, self.cfg.pad_grid)

    @torch.no_grad()
    def solve(self, video: torch.Tensor, y_cond: torch.Tensor,
              y_uncond: torch.Tensor, target_h: int, target_w: int,
              generator: torch.Generator | None = None,
              noise: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
        """video [F, H, W, 3] in [-1, 1] on the device -> the denoised
        latents [1, F, ph/8, pw/8, 4] (fp32). `noise` optionally injects
        'enc_eps', 'diffuse' and 'sde' (a list, one tensor per step) in
        place of draws from `generator`."""
        cfg, sc = self.cfg, self.cfg.sampler
        noise = noise or {}
        w1, w2, h1, h2 = self._padding(target_h, target_w)
        f = video.shape[0]
        t0 = time.perf_counter()
        up = resize_bilinear(video, target_h, target_w)
        padded = F.pad(up[None], (0, 0, w1, w2, h1, h2),
                       value=cfg.pad_value)
        z_lq = self.models.vae.encode(padded, generator=generator,
                                      eps=noise.get('enc_eps'))
        t0 = self._stage('vae_encode', t0)

        t_init = torch.full((1,), sc.total_noise_levels - 1,
                            dtype=torch.long, device=self.device)
        eps = noise.get('diffuse')
        if eps is None:
            eps = torch.randn(z_lq.shape, generator=generator,
                              device=self.device)
        noised = diffuse(self.tables, z_lq.float(), t_init,
                         eps.to(self.device, torch.float32))

        def denoise_chunk(xt, hint, t):
            bb = xt.shape[0]
            yp = torch.cat([y_cond.expand(bb, -1, -1),
                            y_uncond.expand(bb, -1, -1)], dim=0)
            tp = torch.full((bb,), t, dtype=torch.long, device=xt.device)
            v = self.models.unet(xt, tp, yp, hint, cfg_pair=True)
            v_c, v_u = v.chunk(2, dim=0)
            return denoise_to_x0(self.tables, xt, tp, v_c, v_u,
                                 guide_scale=sc.guide_scale,
                                 guide_rescale=sc.guide_rescale)

        chunk_inds = (make_chunks(f, cfg.max_chunk_len,
                                  chunk_overlap_ratio=cfg.chunk_overlap_ratio)
                      if f > cfg.max_chunk_len else [(0, f)])
        x0_fn = chunked_x0_fn(denoise_chunk, z_lq, chunk_inds,
                              mesh=self.mesh)
        sigmas = build_sigma_ladder(
            self.schedule, steps=sc.steps, t_max=sc.total_noise_levels - 1,
            t_min=0, solver_mode=sc.solver_mode,
            discretization=sc.discretization)
        if sc.solver == 'dpmpp_2m_sde':
            gen = sample_dpmpp_2m_sde(x0_fn, noised, self.schedule, sigmas,
                                      generator, eta=sc.eta,
                                      s_noise=sc.s_noise,
                                      noises=noise.get('sde'))
        else:
            gen = sample_heun(x0_fn, noised, self.schedule, sigmas,
                              generator, s_noise=sc.s_noise,
                              noises=noise.get('sde'))
        self._stage('denoise', t0)
        return gen

    @torch.no_grad()
    def decode(self, gen: torch.Tensor, video: torch.Tensor, target_h: int,
               target_w: int) -> torch.Tensor:
        """Latents -> uint8 frames [F, target_h, target_w, 3] on the device
        (windowed VAE decode, unpad, colour fix, round)."""
        w1, _, h1, _ = self._padding(target_h, target_w)
        t0 = time.perf_counter()
        out = self.models.vae.decode(gen)                  # [1, F, ph, pw, 3]
        t0 = self._stage('vae_decode', t0)
        out = out[0, :, h1:h1 + target_h, w1:w1 + target_w, :]
        out = torch.clamp(out.float() * 0.5 + 0.5, 0.0, 1.0) * 255.0
        if self.cfg.color_fix == 'adain':
            out = adain_color_fix(out, video)
        elif self.cfg.color_fix == 'wavelet':
            # the wavelet fix mixes pixels, so its source must have the
            # output's size (AdaIN only reads per-frame statistics)
            out = wavelet_color_fix(
                out, resize_bilinear(video, target_h, target_w))
        out = torch.round(torch.clamp(out, 0.0, 255.0)).to(torch.uint8)
        self._stage('color_fix', t0)
        return out

    # ---------------------------------------------------------- bucket warming
    def warm(self, f: int, h: int, w: int,
             target_res: Optional[tuple[int, int]] = None) -> float:
        """Pay a shape bucket's first-clip costs ahead of traffic: on the
        card, build and load the kernel library, then run one synchronised
        clip of `f` black frames of h x w (the allocator's pools for the
        bucket, each kernel's first launch, the negative prompt's text
        encode). Returns that clip's host seconds (the JAX package, which
        compiles the bucket without running it, returns the compiled
        graph's FLOPs instead)."""
        if self.device.type == 'cuda':
            from ..ops import _build
            _build.build()
            _build.lib()
        t0 = time.perf_counter()
        out = self.enhance_a_video_async(np.zeros((f, h, w, 3), np.uint8),
                                         '', target_res=target_res)
        if out.is_cuda:
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    # ------------------------------------------------------------- interface
    def enhance_a_video_async(self, frames: np.ndarray, prompt: str,
                              seed: int = 666,
                              target_res: Optional[tuple[int, int]] = None,
                              noise: Optional[Mapping[str, Any]] = None
                              ) -> torch.Tensor:
        """Queue the whole clip on the card and return the uint8 output
        tensor on the device without waiting for it."""
        self.stage_seconds = {}
        f, h, w, _ = frames.shape
        if target_res is None:
            target_h, target_w = h * self.cfg.upscale, w * self.cfg.upscale
        else:
            target_h, target_w = target_res
        t0 = time.perf_counter()
        video = torch.as_tensor(frames, device=self.device).float()
        video = (video / 255.0 - 0.5) / 0.5
        y_cond = self.encode_prompt(prompt + self.cfg.positive_prompt)
        y_uncond = self.encode_prompt(self.cfg.negative_prompt)
        self._stage('text', t0)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        gen = self.solve(video, y_cond, y_uncond, target_h, target_w,
                         generator, noise)
        self.last_latents = gen
        return self.decode(gen, video, target_h, target_w)

    def enhance_a_video(self, frames: np.ndarray, prompt: str,
                        seed: int = 666,
                        target_res: Optional[tuple[int, int]] = None,
                        noise: Optional[Mapping[str, Any]] = None
                        ) -> np.ndarray:
        """frames [F, H, W, 3] uint8 RGB -> [F, target_H, target_W, 3]
        uint8: caption = prompt + positive_prompt, target = upscale*(h, w),
        seed 666 by default."""
        out = self.enhance_a_video_async(frames, prompt, seed, target_res,
                                         noise)
        return out.cpu().numpy()
