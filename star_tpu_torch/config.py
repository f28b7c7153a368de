"""Pipeline configuration (counterpart of star_tpu/config.py).

Defaults reproduce the I2VGen-XL inference recipe of STAR: the fast 4+11
DPM++(2M)-SDE ladder from t=899 with its penultimate sigma discarded (14
model calls), CFG 7.5 with rescale 0.2, x4
upscale, 32-frame chunks with 50% overlap, AdaIN colour fix.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

NEGATIVE_PROMPT = (
    'painting, oil painting, illustration, drawing, art, sketch, oil painting, '
    'cartoon, CG Style, 3D render, unreal engine, blurring, dirty, messy, '
    'worst quality, low quality, frames, watermark, signature, jpeg artifacts, '
    'deformed, lowres, over-smooth')

POSITIVE_PROMPT = (
    'Cinematic, High Contrast, highly detailed, taken using a Canon EOS R '
    'camera,   hyper detailed photo - realistic maximum detail, 32k, Color '
    'Grading, ultra HD, extreme meticulous detailing,  skin pore detailing, '
    'hyper sharpness, perfect without deformations.')


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    steps: int = 15
    solver: str = 'dpmpp_2m_sde'        # 'dpmpp_2m_sde' | 'heun'
    solver_mode: str = 'fast'           # 'fast' | 'normal'
    guide_scale: float = 7.5
    guide_rescale: float = 0.2
    total_noise_levels: int = 900       # SDEdit init depth
    discretization: str = 'trailing'
    eta: float = 1.0
    s_noise: float = 1.0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    sampler: SamplerConfig = SamplerConfig()
    upscale: int = 4
    max_chunk_len: int = 32
    chunk_overlap_ratio: float = 0.5
    vae_decode_window: int = 3
    color_fix: str = 'adain'            # 'adain' | 'wavelet' | 'none'
    positive_prompt: str = POSITIVE_PROMPT
    negative_prompt: str = NEGATIVE_PROMPT
    pad_value: float = 1.0              # F.pad constant of the reference
    pad_grid: Tuple[int, int] = (720, 1280)  # UNet training grid; smaller for tests
