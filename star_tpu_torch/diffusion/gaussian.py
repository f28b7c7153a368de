"""v-prediction Gaussian diffusion as plain functions on tensors
(counterpart of star_tpu/diffusion/gaussian.py).

The sigma/alpha tables are float32 tensors on the compute device; the
mixing math runs in float32 whatever the model's compute dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .schedules import Schedule


class DiffusionTables(NamedTuple):
    """float32 schedule tables on the compute device."""
    sigmas: torch.Tensor  # [T]
    alphas: torch.Tensor  # [T]

    @classmethod
    def from_schedule(cls, schedule: Schedule,
                      device: str | torch.device = 'cpu'
                      ) -> 'DiffusionTables':
        return cls(
            sigmas=torch.as_tensor(schedule.sigmas, dtype=torch.float32,
                                   device=device),
            alphas=torch.as_tensor(schedule.alphas, dtype=torch.float32,
                                   device=device))

    @property
    def num_timesteps(self) -> int:
        return self.sigmas.shape[0]


def _bcast(table: torch.Tensor, t: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """Gather table[t] and broadcast to x's rank with leading batch dim."""
    vals = table[t.to(table.device).long()]
    return vals.reshape(vals.shape + (1,) * (x.ndim - vals.ndim))


def diffuse(tables: DiffusionTables, x0: torch.Tensor, t: torch.Tensor,
            noise: torch.Tensor) -> torch.Tensor:
    """xt = alpha_t * x0 + sigma_t * noise."""
    a = _bcast(tables.alphas, t, x0).to(x0.dtype)
    s = _bcast(tables.sigmas, t, x0).to(x0.dtype)
    return a * x0 + s * noise


def get_velocity(tables: DiffusionTables, x0: torch.Tensor, xt: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """The v-prediction target (alpha_t * xt - x0) / sigma_t."""
    a = _bcast(tables.alphas, t, xt).to(xt.dtype)
    s = _bcast(tables.sigmas, t, xt).to(xt.dtype)
    return (a * xt - x0) / s


def get_x0(tables: DiffusionTables, v: torch.Tensor, xt: torch.Tensor,
           t: torch.Tensor) -> torch.Tensor:
    """x0 from a v prediction: alpha_t * xt - sigma_t * v."""
    a = _bcast(tables.alphas, t, xt).to(xt.dtype)
    s = _bcast(tables.sigmas, t, xt).to(xt.dtype)
    return a * xt - s * v


def guide_rescale_combine(y_out: torch.Tensor, u_out: torch.Tensor,
                          guide_scale: float,
                          guide_rescale: float | None) -> torch.Tensor:
    """Classifier-free guidance with the std-ratio rescale: out = u +
    gs*(y-u), then scaled by rescale*std(y)/std(out) + (1-rescale), with
    per-batch-element float32 statistics (ddof=1)."""
    out = u_out + guide_scale * (y_out - u_out)
    if guide_rescale is not None and guide_rescale > 0:
        b = y_out.shape[0]
        y32 = y_out.float().reshape(b, -1)
        o32 = out.float().reshape(b, -1)
        ratio = y32.std(dim=1) / (o32.std(dim=1) + 1e-12)
        scale = guide_rescale * ratio + (1.0 - guide_rescale)
        out = out * scale.reshape((b,) + (1,) * (out.ndim - 1)).to(out.dtype)
    return out


def denoise_to_x0(tables: DiffusionTables, xt: torch.Tensor, t: torch.Tensor,
                  v_cond: torch.Tensor, v_uncond: torch.Tensor | None = None,
                  guide_scale: float | None = None,
                  guide_rescale: float | None = None,
                  clamp: float | None = None) -> torch.Tensor:
    """Combine (guided) v predictions into x0 at timestep t, in float32."""
    if v_uncond is None or guide_scale is None or guide_scale == 1.0:
        out = v_cond
    else:
        out = guide_rescale_combine(v_cond, v_uncond, guide_scale,
                                    guide_rescale)
    a = _bcast(tables.alphas, t, xt)
    s = _bcast(tables.sigmas, t, xt)
    x0 = a * xt.float() - s * out.float()
    if clamp is not None:
        x0 = x0.clamp(-clamp, clamp)
    return x0
