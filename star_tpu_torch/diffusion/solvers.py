"""Diffusion ODE/SDE samplers over a static host sigma ladder
(counterpart of star_tpu/diffusion/solvers.py).

The ladder is a float64 numpy array (possibly +inf at [0] for the
zero-terminal-SNR schedule, 0 at [-1]); the per-step coefficients are host
floats and the state x stays float32 on the device. PyTorch runs eagerly, so
the JAX package's scan over the uniform middle steps is a Python loop here.

SDE noise: the reference draws BrownianTree increments over disjoint
intervals, which are iid N(0,1) after normalisation. The port draws them
from a torch.Generator, or takes them from `noises` (one tensor per step,
used by the tests to feed both frameworks the same numbers).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from ..utils.profiling import annotate
from .schedules import Schedule, sigma_to_t

# model_fn(x_scaled, t_int) -> x0 prediction (same shape as x)
ModelFn = Callable[[torch.Tensor, int], torch.Tensor]


def _c_in(sigma: float) -> float:
    """EDM input preconditioning 1/sqrt(sigma^2+1)."""
    return 1.0 / float(np.sqrt(sigma * sigma + 1.0))


def _ladder_ts(schedule: Schedule, sigmas: np.ndarray) -> list[int]:
    """Rounded integer timesteps for each ladder sigma (model conditioning)."""
    return [0 if s == 0.0 else int(round(sigma_to_t(schedule, float(s))))
            for s in sigmas]


def _normal(x: torch.Tensor, generator: torch.Generator | None,
            noises: Sequence[torch.Tensor] | None, i: int) -> torch.Tensor:
    if noises is not None:
        return noises[i].to(device=x.device, dtype=torch.float32)
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=torch.float32)


def sample_dpmpp_2m_sde(model_fn: ModelFn, x_init: torch.Tensor,
                        schedule: Schedule, sigmas: np.ndarray,
                        generator: torch.Generator | None = None,
                        eta: float = 1.0, s_noise: float = 1.0,
                        solver_type: str = 'midpoint',
                        noises: Sequence[torch.Tensor] | None = None
                        ) -> torch.Tensor:
    """DPM-Solver++(2M) SDE. x_init is the t=899-noised LQ latent; with a
    +inf head sigma the first step is the Euler init from the terminal
    timestep; the last step (sigma_next == 0) returns the denoised x."""
    assert solver_type in ('midpoint', 'heun')
    sigmas = np.asarray(sigmas, dtype=np.float64)
    n = len(sigmas) - 1
    assert n >= 1 and sigmas[-1] == 0.0
    ts = _ladder_ts(schedule, sigmas)

    start = 0
    if np.isinf(sigmas[0]):
        with annotate('sampler.step'):
            denoised = model_fn(x_init.float(), ts[0]).float()
            x = denoised + float(sigmas[1]) * x_init.float()
        start = 1
    else:
        x = x_init.float() * float(sigmas[0])

    old_denoised = None
    h_last = None
    for i in range(start, n - 1):
        with annotate('sampler.step'):
            sig, sig_next = float(sigmas[i]), float(sigmas[i + 1])
            denoised = model_fn(x * _c_in(sig), ts[i]).float()
            h = math.log(sig) - math.log(sig_next)
            eta_h = eta * h
            phi = -math.expm1(-h - eta_h)
            x = (sig_next / sig) * math.exp(-eta_h) * x + phi * denoised
            if old_denoised is not None:
                r = h_last / h
                coef = (phi / (-h - eta_h) + 1.0 if solver_type == 'heun'
                        else 0.5 * phi)
                x = x + coef * (1.0 / r) * (denoised - old_denoised)
            if eta > 0 and s_noise != 0.0:
                x = x + _normal(x, generator, noises, i) * (
                    sig_next * math.sqrt(-math.expm1(-2.0 * eta_h))
                    * s_noise)
            old_denoised, h_last = denoised, h

    # terminal step: sigma_next == 0 -> x = denoised
    sig = float(sigmas[n - 1])
    with annotate('sampler.step'):
        return model_fn(x * _c_in(sig), ts[n - 1]).float()


def sample_heun(model_fn: ModelFn, x_init: torch.Tensor, schedule: Schedule,
                sigmas: np.ndarray, generator: torch.Generator | None = None,
                s_churn: float = 0.0, s_tmin: float = 0.0,
                s_tmax: float = float('inf'), s_noise: float = 1.0,
                noises: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
    """Karras Algorithm 2 (Heun) over a static sigma ladder."""
    sigmas = np.asarray(sigmas, dtype=np.float64)
    n = len(sigmas) - 1
    ts = _ladder_ts(schedule, sigmas)
    x = (x_init.float() if np.isinf(sigmas[0])
         else x_init.float() * float(sigmas[0]))

    for i in range(n):
        sig, sig_next = float(sigmas[i]), float(sigmas[i + 1])
        gamma = 0.0
        if s_tmin <= sig <= s_tmax and np.isfinite(sig):
            gamma = min(s_churn / n, 2**0.5 - 1.0)
        sigma_hat = sig * (gamma + 1.0)
        if gamma > 0:
            eps = _normal(x, generator, noises, i) * s_noise
            x = x + eps * float(np.sqrt(sigma_hat**2 - sig**2))
        if np.isinf(sig):
            with annotate('sampler.step'):
                denoised = model_fn(x_init.float(), ts[i]).float()
                x = denoised + sig_next * (gamma + 1.0) * x_init.float()
            continue
        with annotate('sampler.step'):
            denoised = model_fn(x * _c_in(sigma_hat), ts[i]).float()
            d = (x - denoised) / sigma_hat
            dt = sig_next - sigma_hat
            x_2 = x + d * dt
        if sig_next == 0.0:
            x = x_2
            continue
        with annotate('sampler.step'):      # Heun's correction
            denoised_2 = model_fn(x_2 * _c_in(sig_next), ts[i + 1]).float()
            d_2 = (x_2 - denoised_2) / sig_next
            x = x + (d + d_2) / 2.0 * dt
    return x
