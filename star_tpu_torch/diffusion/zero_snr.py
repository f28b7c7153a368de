"""ZeroSNR-DDPM discretization and VideoScaling denoiser preconditioning of
the CogVideoX path (counterpart of star_tpu/diffusion/zero_snr.py, host
float64 numpy).

Linear-beta alpha-bar ladder with an optional logSNR shift, rescaled so
the terminal sqrt(alpha-bar) is exactly 0; the EDM and Legacy-DDPM sigma
ladders the reference engine can select; the v-prediction scaling
(c_skip = sqrt(alpha-bar), c_out = -sqrt(1 - alpha-bar), c_in = 1) and
the DynamicCFG scale schedule.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_beta_schedule_linear(n: int, linear_start: float = 0.00085,
                              linear_end: float = 0.0120) -> np.ndarray:
    """DDPM 'linear' schedule: betas = linspace(sqrt(start), sqrt(end), n)^2."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n,
                       dtype=np.float64) ** 2


class ZeroSNRDDPMDiscretization:
    """Returns the sqrt(alpha-bar) ladder (descending in noise; index 0 is
    the noisiest when flip=True, matching the reference default)."""

    def __init__(self, linear_start: float = 0.00085,
                 linear_end: float = 0.0120, num_timesteps: int = 1000,
                 shift_scale: float = 1.0):
        betas = make_beta_schedule_linear(num_timesteps, linear_start,
                                          linear_end)
        alphas_cumprod = np.cumprod(1.0 - betas)
        # logSNR shift
        alphas_cumprod = alphas_cumprod / (
            shift_scale + (1.0 - shift_scale) * alphas_cumprod)
        self.alphas_cumprod = alphas_cumprod
        self.num_timesteps = num_timesteps

    def get_sqrt_alphas(self, n: int, flip: bool = True,
                        return_idx: bool = False):
        if n < self.num_timesteps:
            timesteps = np.linspace(self.num_timesteps - 1, 0, n,
                                    endpoint=False).astype(int)[::-1]
            ac = self.alphas_cumprod[timesteps]
        elif n == self.num_timesteps:
            timesteps = np.arange(n)
            ac = self.alphas_cumprod
        else:
            raise ValueError(n)
        s = np.sqrt(ac)
        # zero-terminal-SNR rescale: force s[-1] -> 0 keeping s[0]
        s0, sT = s[0], s[-1]
        s = (s - sT) * (s0 / (s0 - sT))
        if flip:
            s = s[::-1].copy()
            # note: timesteps are NOT flipped in the reference (they get
            # consumed via timesteps[-(i+1)] in the sampler)
        return (s, timesteps) if return_idx else s


class EDMDiscretization:
    """Karras rho-schedule sigma ladder (discretizer.py:32-43): sigmas
    interpolate sigma_max -> sigma_min in sigma^(1/rho) space. Config-
    reachable in the reference engine (never selected by STAR's configs,
    ported for capability parity)."""

    def __init__(self, sigma_min: float = 0.002, sigma_max: float = 80.0,
                 rho: float = 7.0):
        self.sigma_min, self.sigma_max, self.rho = sigma_min, sigma_max, rho

    def get_sigmas(self, n: int) -> np.ndarray:
        ramp = np.linspace(0.0, 1.0, n, dtype=np.float64)
        min_inv = self.sigma_min ** (1.0 / self.rho)
        max_inv = self.sigma_max ** (1.0 / self.rho)
        return (max_inv + ramp * (min_inv - max_inv)) ** self.rho

    def __call__(self, n: int, do_append_zero: bool = True,
                 flip: bool = False) -> np.ndarray:
        s = self.get_sigmas(n)
        if do_append_zero:
            s = np.concatenate([s, [0.0]])
        return s[::-1].copy() if flip else s


class LegacyDDPMDiscretization:
    """Pre-ZeroSNR DDPM sigma ladder (discretizer.py:46-72):
    sigma_t = sqrt((1-abar)/abar) over the linear-beta schedule, descending
    (14.4 -> 0.029 at n=1000 per the reference comment)."""

    def __init__(self, linear_start: float = 0.00085,
                 linear_end: float = 0.0120, num_timesteps: int = 1000):
        betas = make_beta_schedule_linear(num_timesteps, linear_start,
                                          linear_end)
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self.num_timesteps = num_timesteps

    def get_sigmas(self, n: int) -> np.ndarray:
        if n < self.num_timesteps:
            timesteps = np.linspace(self.num_timesteps - 1, 0, n,
                                    endpoint=False).astype(int)[::-1]
            ac = self.alphas_cumprod[timesteps]
        elif n == self.num_timesteps:
            ac = self.alphas_cumprod
        else:
            raise ValueError(n)
        return np.sqrt((1.0 - ac) / ac)[::-1].copy()   # descending

    def __call__(self, n: int, do_append_zero: bool = True,
                 flip: bool = False) -> np.ndarray:
        s = self.get_sigmas(n)
        if do_append_zero:
            s = np.concatenate([s, [0.0]])
        return s[::-1].copy() if flip else s


def video_scaling(sqrt_alpha: np.ndarray | float
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """(c_skip, c_out, c_in) for the VideoScaling v-pred convention:
    c_skip = sqrt(alpha_bar), c_out = -sqrt(1 - alpha_bar), c_in = 1."""
    a = np.asarray(sqrt_alpha, dtype=np.float64)
    return a, -np.sqrt(1.0 - a**2), 1.0


def dynamic_cfg_scale(scale: float, exp: float, num_steps: int,
                      step_index: float) -> float:
    """DynamicCFG schedule 1 + scale*(1-cos(pi*(i/N)^exp))/2
    (guiders.py:61-79)."""
    import math
    return 1.0 + scale * (1.0 - math.cos(
        math.pi * (step_index / num_steps) ** exp)) / 2.0
