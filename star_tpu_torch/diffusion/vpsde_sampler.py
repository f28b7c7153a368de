"""VPSDE / VPODE DPM++(2M) in the sqrt(alpha-bar) parameterisation, the
CogVideoX path's sampler (counterpart of
star_tpu/diffusion/vpsde_sampler.py).

The ladder appends sqrt(alpha-bar) = 1 (clean) and runs `num_steps` steps:
step 0 without history, the middle steps with the 2M correction, and the
final step returns the denoised estimate itself. DynamicCFG's step index
is num_steps - t (t the raw integer timestep of the step). Every per-step
constant is host float64; the state is fp32. The SDE variant adds
mult_noise * N(0, 1) at every step but the last: the noises are injected
(`noises`, one tensor per step) or drawn from `generator`. A plain Python
loop takes the place of the JAX package's lax.scan.

denoise_fn(x, t_int, sqrt_alpha, cfg_scale) -> the guided denoised x0
(fp32, x's shape); the caller owns the CFG pair and the LQ channel concat.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .zero_snr import ZeroSNRDDPMDiscretization, dynamic_cfg_scale

DenoiseFn = Callable[[torch.Tensor, int, float, float], torch.Tensor]


def _lamb(s):  # log(sqrt(a)/sqrt(1-a)) with a = s^2; -inf at s = 0
    with np.errstate(divide='ignore'):
        return np.log(s / np.sqrt(1.0 - s * s))


def vpsde_dpmpp_2m_ladder(disc: ZeroSNRDDPMDiscretization, num_steps: int):
    """-> (sqrt_alpha ladder with the terminal 1.0 [n+1], the int timestep
    of each step [n])."""
    s, idx = disc.get_sqrt_alphas(num_steps, flip=True, return_idx=True)
    ladder = np.concatenate([s, [1.0]])
    t_for_step = np.concatenate([[-1], np.asarray(idx)])[::-1][:num_steps]
    return ladder, t_for_step.astype(np.int64)


def step_constants(ladder: np.ndarray, i: int, sde: bool
                   ) -> tuple[float, float, float, float, float]:
    """(mult1, mult2, mult_noise, 2M weight of denoised, 2M weight of the
    previous denoised) of step i, in float64. At step 0 the ladder starts
    at sqrt_alpha = 0, so h = +inf, exp(-h) = 0 and expm1(-2h) = -1."""
    with np.errstate(divide='ignore', over='ignore'):
        a, a_next = np.float64(ladder[i]), np.float64(ladder[i + 1])
        lam, lam_next = _lamb(a), _lamb(a_next)
        h = lam_next - lam
        if sde:
            mult1 = float(np.sqrt((1 - a_next ** 2) / (1 - a ** 2))
                          * np.exp(-h))
            mult2 = float(np.expm1(-2.0 * h) * a_next)
            mult_noise = float(np.sqrt(1 - a_next ** 2)
                               * np.sqrt(1 - np.exp(-2 * h)))
        else:
            mult1 = float(np.sqrt((1 - a_next ** 2) / (1 - a ** 2)))
            mult2 = float(np.expm1(-h) * a_next)
            mult_noise = 0.0
        if i == 0:
            return mult1, mult2, mult_noise, 0.0, 0.0
        r = (lam - _lamb(np.float64(ladder[i - 1]))) / h
        return (mult1, mult2, mult_noise, float(1.0 + 1.0 / (2 * r)),
                float(1.0 / (2 * r)))


def _sample(denoise_fn: DenoiseFn, x_init: torch.Tensor,
            disc: ZeroSNRDDPMDiscretization, num_steps: int,
            guider_scale: float, guider_exp: float, sde: bool,
            generator: Optional[torch.Generator],
            noises: Optional[Sequence[torch.Tensor]]) -> torch.Tensor:
    ladder, t_for_step = vpsde_dpmpp_2m_ladder(disc, num_steps)
    n = num_steps
    cfg_scales = [dynamic_cfg_scale(guider_scale, guider_exp, n,
                                    float(n - int(t))) for t in t_for_step]
    x = x_init.float()
    old_denoised = None
    for i in range(n):
        denoised = denoise_fn(x, int(t_for_step[i]), float(ladder[i]),
                              cfg_scales[i]).float()
        if i == n - 1:          # the final step returns the estimate
            return denoised
        m1, m2, mn, m3, m4 = step_constants(ladder, i, sde)
        d = denoised if i == 0 else m3 * denoised - m4 * old_denoised
        x = m1 * x - m2 * d
        if sde:
            if noises is not None:
                noise = noises[i].to(x.device, torch.float32)
            else:
                noise = torch.randn(x.shape, generator=generator,
                                    device=x.device)
            x = x + mn * noise
        old_denoised = denoised
    return x


def sample_vpsde_dpmpp_2m(denoise_fn: DenoiseFn, x_init: torch.Tensor,
                          disc: ZeroSNRDDPMDiscretization, num_steps: int,
                          generator: Optional[torch.Generator] = None,
                          guider_scale: float = 6.0, guider_exp: float = 5.0,
                          noises: Optional[Sequence[torch.Tensor]] = None
                          ) -> torch.Tensor:
    """The stochastic variant, STAR's configured sampler. `noises`, when
    given, holds the fresh noise of steps 0..n-2."""
    return _sample(denoise_fn, x_init, disc, num_steps, guider_scale,
                   guider_exp, True, generator, noises)


def sample_vpode_dpmpp_2m(denoise_fn: DenoiseFn, x_init: torch.Tensor,
                          disc: ZeroSNRDDPMDiscretization, num_steps: int,
                          guider_scale: float = 6.0, guider_exp: float = 5.0
                          ) -> torch.Tensor:
    """The deterministic VPODE variant: the same ladder, timesteps and
    DynamicCFG, ODE multipliers and no noise."""
    return _sample(denoise_fn, x_init, disc, num_steps, guider_scale,
                   guider_exp, False, None, None)
