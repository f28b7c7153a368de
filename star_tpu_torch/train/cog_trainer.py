"""CogVideoX SR train step: LoRA + final layer + proj_sr + LIEM
(counterpart of star_tpu/train/cog_trainer.py).

The loss is that of the JAX package (the reference's SRDiffusionLoss):
sqrt(alpha-bar) indices drawn uniform over the 1000-entry ZeroSNR table
(flip=False: index == timestep), noised = a x + sqrt(1 - a^2) eps, the LQ
latent concatenated on the channels, x0_hat = -sqrt(1 - a^2) v + a noised
from the DiT's v-prediction, loss = mean(w (x0_hat - x0)^2) with
w = 1 / (1 - a^2); with the frequency loss, the timestep-aware Fourier
term of x0_hat decoded to pixels is added.

The mixed precision, the optimizer and the data parallelism are the
I2VGen trainer's (train/trainer.py): fp32 masters of the trainable set
beside the bf16 module, updated in place by clip_by_global_norm + AdamW;
under a mesh with data > 1, the global batch's draws and metrics and the
gradients averaged over 'data'. The AdamW is
optax.adamw's default, which the JAX step uses: weight decay 1e-4, no
warmup. The EMA covers the masters; the JAX EMA covers the whole tree,
whose frozen leaves it leaves where they are.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from ..diffusion.zero_snr import ZeroSNRDDPMDiscretization
from ..parallel.mesh import AXIS_DATA, Mesh, all_reduce, draw_rows, \
    gather_data_rows
from .losses import star_sr_loss
from .trainer import (Optimizer, TrainConfig, TrainState, apply_update,
                      data_parallel, make_train_state, mean_grads_over_data,
                      trainable_mask)

COG_TRAINABLE = ('lora_a', 'lora_b', 'final_linear', 'final_adaln',
                 'final_ln', 'proj_sr', 'spa_local', 'temp_local')


def cog_is_trainable(name: str) -> bool:
    """LoRA A/B, the final layer, proj_sr and the LIEM gates (the
    reference's disable_untrainable_params)."""
    return any(s in name for s in COG_TRAINABLE)


def cog_trainable_mask(model: nn.Module) -> dict[str, bool]:
    return trainable_mask(model, cog_is_trainable)


@dataclasses.dataclass(frozen=True)
class CogTrainConfig:
    learning_rate: float = 1e-4
    max_grad_norm: float = 1.0
    num_idx: int = 1000
    shift_scale: float = 1.0
    freq_loss: bool = True
    freq_grad: bool = False
    ema_decay: float = 0.0        # 0 disables


def make_cog_train_state(cfg: CogTrainConfig, model: nn.Module
                         ) -> tuple[TrainState, Optimizer]:
    """fp32 masters of the DiT's trainable set, the optimizer over them and
    the EMA of them when cfg.ema_decay > 0; the module made ready to train
    (frozen parameters without grad). The optimizer is optax.adamw's
    default, which the JAX step builds from the learning rate alone:
    weight decay 1e-4, no warmup."""
    opt_cfg = TrainConfig(learning_rate=cfg.learning_rate,
                          max_grad_norm=cfg.max_grad_norm,
                          weight_decay=1e-4, ema_decay=cfg.ema_decay)
    return make_train_state(opt_cfg, model, cog_is_trainable)


def make_cog_train_step(cfg: CogTrainConfig, model: nn.Module, tx: Optimizer,
                        vae_decode: Optional[Callable[[torch.Tensor],
                                                      torch.Tensor]] = None,
                        mesh: Optional[Mesh] = None):
    """Build the train step over `model` (the DiT that make_cog_train_state
    prepared; called as model(x, idx, y)).

    batch: dict with gt_latent [B, T, h, w, C], lq_latent [B, T, h, w, C],
    y [B, L, 4096], optional gt_pixels [B, F, H, W, 3] (for the frequency
    loss): this rank's rows of the global batch under a mesh with
    data > 1. The indices and the noise are drawn from `generator` unless
    given as `idx` [B] and `noise` (tests replay the JAX draws through
    them).

      train_step(state, batch, generator, idx=, noise=) -> (state, metrics)
      train_step.loss_and_grads(batch, generator, idx=, noise=) -> metrics;
          the gradients stay in the trainable parameters' .grad
    """
    live = {n: p for n, p in model.named_parameters() if n in tx.names}
    dp = data_parallel(mesh)
    if dp and cfg.freq_grad:
        raise ValueError('freq_grad under data parallelism: the frequency '
                         'term is computed on the gathered batch, without '
                         'gradient')
    sqrt_alphas_np = ZeroSNRDDPMDiscretization(
        shift_scale=cfg.shift_scale).get_sqrt_alphas(cfg.num_idx, flip=False)
    tables: dict = {}

    def sqrt_alphas(device) -> torch.Tensor:
        key = str(device)
        if key not in tables:
            tables[key] = torch.tensor(sqrt_alphas_np, dtype=torch.float32,
                                       device=device)
        return tables[key]

    def loss_and_grads(batch, generator: Optional[torch.Generator] = None,
                       *, idx: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None):
        gt = batch['gt_latent'].float()
        if idx is None:
            idx = draw_rows(lambda s: torch.randint(
                0, cfg.num_idx, s, generator=generator, device=gt.device),
                gt.shape[:1], mesh)
        if noise is None:
            noise = draw_rows(lambda s: torch.randn(
                s, generator=generator, device=gt.device), gt.shape, mesh)
        for p in live.values():
            p.grad = None
        a = sqrt_alphas(gt.device)[idx].reshape((-1,) + (1,) * (gt.ndim - 1))
        sigma = torch.sqrt(1.0 - a * a)
        noised = a * gt + sigma * noise
        xin = torch.cat([noised, batch['lq_latent'].float()], dim=-1)
        v = model(xin, idx, batch['y']).float()
        x0_hat = v * -sigma + noised * a
        w = 1.0 / (1.0 - a * a)                 # v-prediction weighting
        loss_l2 = torch.mean(w * (x0_hat - gt) ** 2)
        metrics = {'loss_v': loss_l2}
        loss = loss_l2
        if dp:
            # this rank's mean; the metrics are the global batch's
            loss_l2.backward()
            loss_l2 = all_reduce(loss_l2.detach().clone(), mesh,
                                 AXIS_DATA) / mesh.size(AXIS_DATA)
            metrics = {'loss_v': loss_l2}
            loss = loss_l2
        if cfg.freq_loss and vae_decode is not None and 'gt_pixels' in batch:
            with torch.set_grad_enabled(cfg.freq_grad):
                pred_pixels = vae_decode(x0_hat if cfg.freq_grad
                                         else x0_hat.detach())
            gt_pixels = batch['gt_pixels']
            if dp:
                pred_pixels, gt_pixels, idx = (
                    gather_data_rows(x.detach(), mesh)
                    for x in (pred_pixels, gt_pixels, idx))
            _, m2 = star_sr_loss(v, v, idx, pred_pixels, gt_pixels,
                                 freq_grad=cfg.freq_grad)
            tn = idx.float() / 999.0
            ct = torch.mean(tn ** 2)
            weight_t = torch.mean(1.0 - tn)
            loss_t = 0.01 * (ct * m2['loss_low'] + (1 - ct) * m2['loss_high'])
            loss = loss_l2 + weight_t * loss_t
            metrics.update(loss_low=m2['loss_low'],
                           loss_high=m2['loss_high'])
        metrics['total_loss'] = loss
        if not dp:
            loss.backward()
        mean_grads_over_data(live, mesh)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics['grad_norm'] = tx.global_norm(
            {n: p.grad for n, p in live.items()})
        return metrics

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None, *,
                   idx: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None):
        metrics = loss_and_grads(batch, generator, idx=idx, noise=noise)
        return apply_update(cfg, state, tx, live, metrics)

    train_step.loss_and_grads = loss_and_grads
    return train_step
