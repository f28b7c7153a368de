"""Noise schedules as pure host-side (numpy) functions.

The port's own copy of star_tpu/diffusion/schedules.py (the port imports
nothing of star_tpu): logsnr-cosine-interp schedule, zero-terminal-SNR
rescale, karras ladder, the trailing 4+11 ladder. These are tiny 1-D tables
computed once per model build, so they live on the host in float64 and are
handed to the device as float32 tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


def betas_to_sigmas(betas: np.ndarray) -> np.ndarray:
    return np.sqrt(1.0 - np.cumprod(1.0 - betas))


def sigmas_to_betas(sigmas: np.ndarray) -> np.ndarray:
    square_alphas = 1.0 - sigmas**2
    betas = 1.0 - np.concatenate(
        [square_alphas[:1], square_alphas[1:] / square_alphas[:-1]])
    return betas


def logsnrs_to_sigmas(logsnrs: np.ndarray) -> np.ndarray:
    # sigmoid(-logsnr) in a numerically stable form
    return np.sqrt(1.0 / (1.0 + np.exp(logsnrs)))


def sigmas_to_logsnrs(sigmas: np.ndarray) -> np.ndarray:
    s2 = sigmas**2
    return np.log(s2 / (1.0 - s2))


def _logsnr_cosine(n: int, logsnr_min: float = -15.0,
                   logsnr_max: float = 15.0) -> np.ndarray:
    t_min = math.atan(math.exp(-0.5 * logsnr_min))
    t_max = math.atan(math.exp(-0.5 * logsnr_max))
    t = np.linspace(1.0, 0.0, n)
    return -2.0 * np.log(np.tan(t_min + t * (t_max - t_min)))


def _logsnr_cosine_shifted(n: int, logsnr_min: float = -15.0,
                           logsnr_max: float = 15.0,
                           scale: float = 2.0) -> np.ndarray:
    return _logsnr_cosine(n, logsnr_min, logsnr_max) + 2.0 * math.log(1.0 / scale)


def _logsnr_cosine_interp(n: int, logsnr_min: float = -15.0,
                          logsnr_max: float = 15.0, scale_min: float = 2.0,
                          scale_max: float = 4.0) -> np.ndarray:
    t = np.linspace(1.0, 0.0, n)
    lo = _logsnr_cosine_shifted(n, logsnr_min, logsnr_max, scale_min)
    hi = _logsnr_cosine_shifted(n, logsnr_min, logsnr_max, scale_max)
    return t * lo + (1.0 - t) * hi


def logsnr_cosine_interp_schedule(n: int, logsnr_min: float = -15.0,
                                  logsnr_max: float = 15.0,
                                  scale_min: float = 2.0,
                                  scale_max: float = 4.0) -> np.ndarray:
    return logsnrs_to_sigmas(
        _logsnr_cosine_interp(n, logsnr_min, logsnr_max, scale_min, scale_max))


def karras_schedule(n: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
                    rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) ladder, mapped back to VP sigma in (0, 1)."""
    ramp = np.linspace(1.0, 0.0, n)
    min_inv_rho = sigma_min ** (1.0 / rho)
    max_inv_rho = sigma_max ** (1.0 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return np.sqrt(sigmas**2 / (1.0 + sigmas**2))


def noise_schedule(schedule: str = 'logsnr_cosine_interp', n: int = 1000,
                   zero_terminal_snr: bool = False, **kwargs) -> np.ndarray:
    sigmas = {
        'logsnr_cosine_interp': logsnr_cosine_interp_schedule,
    }[schedule](n, **kwargs)

    if zero_terminal_snr and sigmas.max() != 1.0:
        # Affine rescale so sigma[last] == 1 (terminal SNR == 0) while keeping
        # sigma[first] fixed.
        scale = (1.0 - sigmas.min()) / (sigmas.max() - sigmas.min())
        sigmas = sigmas.min() + scale * (sigmas - sigmas.min())
    return sigmas


class Schedule(NamedTuple):
    """A discrete VP diffusion schedule.

    sigmas/alphas are float64 numpy tables of length num_timesteps;
    alphas = sqrt(1 - sigmas^2).
    """
    sigmas: np.ndarray
    alphas: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return len(self.sigmas)

    @classmethod
    def from_sigmas(cls, sigmas: np.ndarray) -> 'Schedule':
        sigmas = np.asarray(sigmas, dtype=np.float64)
        return cls(sigmas=sigmas, alphas=np.sqrt(1.0 - sigmas**2))


def default_star_schedule(n: int = 1000) -> Schedule:
    """The schedule STAR's I2VGen-XL path is trained/sampled with
    (reference: video_to_video_model.py:46-52)."""
    return Schedule.from_sigmas(
        noise_schedule('logsnr_cosine_interp', n=n, zero_terminal_snr=True,
                       scale_min=2.0, scale_max=4.0))


# --- sigma <-> t interpolation in EDM parameterization -----------------------
#
# The solvers run in "EDM sigma" space: sigma_edm = sigma_vp / alpha_vp.
# log_sigmas below is log(sigma_edm) per integer timestep; with a
# zero-terminal-SNR schedule the last entry is +inf.

def log_sigmas_edm(schedule: Schedule) -> np.ndarray:
    with np.errstate(divide='ignore'):
        return np.log(np.sqrt(schedule.sigmas**2 / (1.0 - schedule.sigmas**2)))


def t_to_sigma(schedule: Schedule, t: np.ndarray) -> np.ndarray:
    """Fractional timestep -> EDM sigma (linear interp in log-sigma).

    Mirrors GaussianDiffusion._t_to_sigma (diffusion_sdedit.py:435-443):
    non-finite log-sigmas map to +inf.
    """
    t = np.asarray(t, dtype=np.float64)
    log_sigmas = log_sigmas_edm(schedule)
    low_idx = np.floor(t).astype(np.int64)
    high_idx = np.ceil(t).astype(np.int64)
    w = t - low_idx
    with np.errstate(invalid='ignore'):
        log_sigma = (1.0 - w) * log_sigmas[low_idx] + w * log_sigmas[high_idx]
    log_sigma = np.where(np.isfinite(log_sigma), log_sigma, np.inf)
    return np.exp(log_sigma)


def sigma_to_t(schedule: Schedule, sigma: float) -> float:
    """EDM sigma -> fractional timestep (inverse of t_to_sigma).

    Mirrors GaussianDiffusion._sigma_to_t (diffusion_sdedit.py:415-433).
    """
    if np.isinf(sigma):
        return float(schedule.num_timesteps - 1)
    log_sigmas = log_sigmas_edm(schedule)
    log_sigma = math.log(sigma)
    dists = log_sigma - log_sigmas
    low_idx = int(np.argmax(np.cumsum(dists >= 0)))
    low_idx = min(low_idx, len(log_sigmas) - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = float(np.clip((low - log_sigma) / (low - high), 0.0, 1.0))
    return (1.0 - w) * low_idx + w * high_idx


def trailing_timesteps(num_timesteps: int, steps: int, t_max: int | None = None,
                       t_min: int = 0, solver_mode: str = 'fast',
                       discard_penultimate_step: bool = True) -> np.ndarray:
    """'trailing' discretization incl. STAR's fast 4+11 split at t_mid=500.

    Returns the float timestep ladder (without the appended 0-sigma terminal);
    mirrors diffusion_sdedit.py:356-380.
    """
    t_max = num_timesteps - 1 if t_max is None else t_max
    steps = steps + (1 if discard_penultimate_step else 0)
    if solver_mode == 'fast':
        t_mid = 500
        steps1 = np.arange(t_max, t_mid - 1, -((t_max - t_mid + 1) / 4.0))
        steps2 = np.arange(t_mid, t_min - 1, -((t_mid - t_min + 1) / 11.0))
        ladder = np.concatenate([steps1, steps2])
    else:
        ladder = np.arange(t_max, t_min - 1, -((t_max - t_min + 1) / steps))
    return np.clip(ladder, t_min, t_max)


def build_sigma_ladder(schedule: Schedule, steps: int, t_max: int | None = None,
                       t_min: int = 0, solver_mode: str = 'fast',
                       discretization: str = 'trailing',
                       discard_penultimate_step: bool = True) -> np.ndarray:
    """Full solver sigma ladder: timesteps -> EDM sigmas, append terminal 0,
    optionally discard the penultimate sigma (DPM++2M-SDE convention)."""
    num_t = schedule.num_timesteps
    t_max = num_t - 1 if t_max is None else t_max
    if discretization == 'trailing':
        ladder = trailing_timesteps(num_t, steps, t_max, t_min, solver_mode,
                                    discard_penultimate_step)
    elif discretization == 'linspace':
        n = steps + (1 if discard_penultimate_step else 0)
        ladder = np.linspace(t_max, t_min, n)
    elif discretization == 'leading':
        n = steps + (1 if discard_penultimate_step else 0)
        ladder = np.arange(t_min, t_max + 1, (t_max - t_min + 1) / n)[::-1]
        ladder = np.clip(ladder, t_min, t_max)
    else:
        raise ValueError(f'unknown discretization {discretization!r}')
    sigmas = t_to_sigma(schedule, ladder)
    sigmas = np.concatenate([sigmas, [0.0]])
    if discard_penultimate_step:
        sigmas = np.concatenate([sigmas[:-2], sigmas[-1:]])
    return sigmas
