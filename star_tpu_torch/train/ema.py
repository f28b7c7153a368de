"""EMA of parameters (counterpart of star_tpu/train/ema.py)."""

from __future__ import annotations

import torch


def init_ema(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: p.detach().clone() for k, p in params.items()}


def update_ema(ema_params: dict[str, torch.Tensor],
               params: dict[str, torch.Tensor],
               decay: float = 0.9999) -> dict[str, torch.Tensor]:
    """ema <- decay * ema + (1-decay) * params (a new dict)."""
    return {k: e * decay + params[k].detach().to(e.dtype) * (1.0 - decay)
            for k, e in ema_params.items()}
