"""Trainer for the I2VGen-XL SR ControlNet (+ LIEM) fine-tune
(counterpart of star_tpu/train/trainer.py).

The trainable set is the ControlNet and the UNet's LIEM ('local1',
'local2') parameters; everything else is frozen (requires_grad False) and
carries no optimizer state.

Mixed precision follows flax's semantics: the trainable set is held as
fp32 masters in the TrainState, outside the module, with the AdamW
moments; the module's parameters, trainable ones included, stay in the
compute dtype (that of the frozen set, bf16 on the card). The forward
therefore sees the masters rounded to bf16, the gradient is the bf16
cotangent widened to fp32, and after each step the masters are copied back
into the module, rounded once.

In-place updates: `train_step` steps the masters, the moments and the
module's trainable parameters in place (the returned TrainState shares
them with the one passed in), where the JAX step returns new arrays; at
the full width these are gigabytes that need not be copied.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ..diffusion import DiffusionTables, diffuse, get_velocity, get_x0
from .ema import init_ema, update_ema
from .losses import star_sr_loss


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    num_timesteps: int = 1000
    freq_loss: bool = True        # compute the frequency metric/loss
    freq_grad: bool = False       # reference parity: metric only
    warmup_steps: int = 0
    ema_decay: float = 0.0        # 0 disables; the reference uses 0.9999


def is_trainable(name: str) -> bool:
    """ControlNet parameters + the UNet's LIEM ('local*') parameters."""
    return ('controlnet' in name) or ('local1' in name) or ('local2' in name)


def trainable_mask(model: nn.Module) -> dict[str, bool]:
    """Parameter name (the flax path with '.') -> trainable."""
    return {n: is_trainable(n) for n, _ in model.named_parameters()}


def stop_frozen_grads(model: nn.Module,
                      mask: Optional[dict[str, bool]] = None) -> nn.Module:
    """Frozen parameters get requires_grad=False (autograd then computes no
    cotangent for them), trainable ones requires_grad=True."""
    mask = trainable_mask(model) if mask is None else mask
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n])
    return model


def cast_frozen(model: nn.Module, dtype: torch.dtype = torch.bfloat16,
                mask: Optional[dict[str, bool]] = None) -> nn.Module:
    """Hold the frozen parameters in `dtype`, in place; trainable ones keep
    theirs until make_train_state takes them as fp32 masters."""
    mask = trainable_mask(model) if mask is None else mask
    with torch.no_grad():
        for n, p in model.named_parameters():
            if not mask[n]:
                p.data = p.data.to(dtype)
    return model


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


class TrainState(NamedTuple):
    step: int
    params: dict[str, torch.Tensor]     # fp32 masters of the trainable set
    opt_state: 'Optimizer'              # holds the AdamW moments
    ema_params: Optional[dict[str, torch.Tensor]] = None


class Optimizer:
    """optax's chain(clip_by_global_norm, adamw) over the fp32 masters:
    gradients scaled by max_grad_norm / norm when the norm reaches it, then
    torch's AdamW (the same update and decoupled decay as optax.adamw),
    with the linear warmup of optax.linear_schedule(0, lr, warmup_steps):
    learning rate lr * min(count, n) / n at update `count` (0 first)."""

    def __init__(self, cfg: TrainConfig, params: dict[str, torch.Tensor]):
        self.cfg = cfg
        self.names = list(params)
        self.adamw = torch.optim.AdamW(
            list(params.values()), lr=cfg.learning_rate,
            betas=(cfg.adam_beta1, cfg.adam_beta2), eps=cfg.adam_eps,
            weight_decay=cfg.weight_decay)

    def lr(self, count: int) -> float:
        n = self.cfg.warmup_steps
        return self.cfg.learning_rate * (min(count, n) / n if n else 1.0)

    def update(self, grads: dict[str, torch.Tensor],
               count: int) -> torch.Tensor:
        """One step of the masters in place; returns the global norm of
        `grads` before clipping."""
        gs = [grads[n] for n in self.names]
        norm = global_norm(gs)
        max_norm = self.cfg.max_grad_norm
        factor = torch.where(norm < max_norm, torch.ones_like(norm),
                             max_norm / norm)
        for p, g in zip(self.adamw.param_groups[0]['params'], gs):
            p.grad = g.float() * factor
        self.adamw.param_groups[0]['lr'] = self.lr(count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        return norm


def make_optimizer(cfg: TrainConfig,
                   params: dict[str, torch.Tensor]) -> Optimizer:
    return Optimizer(cfg, params)


def make_train_state(cfg: TrainConfig,
                     model: nn.Module) -> tuple[TrainState, Optimizer]:
    """fp32 masters of the model's trainable set (from their current
    values), the optimizer over them, and the model made ready to train:
    frozen parameters without grad, trainable ones in the compute dtype
    (the frozen set's dtype) with grad."""
    mask = trainable_mask(model)
    named = dict(model.named_parameters())
    dtypes = {p.dtype for n, p in named.items() if not mask[n]}
    if len(dtypes) != 1:
        raise ValueError(f'the frozen parameters have dtypes {dtypes}; '
                         'hold them in one compute dtype (cast_frozen)')
    compute = dtypes.pop()
    masters = {n: p.detach().float().clone() for n, p in named.items()
               if mask[n]}
    with torch.no_grad():
        for n in masters:
            named[n].data = named[n].data.to(compute)
    stop_frozen_grads(model, mask)
    tx = make_optimizer(cfg, masters)
    ema = init_ema(masters) if cfg.ema_decay > 0 else None
    return TrainState(0, masters, tx, ema), tx


def make_train_step(cfg: TrainConfig, model: nn.Module,
                    tables: DiffusionTables, tx: Optimizer,
                    vae_decode: Optional[Callable[[torch.Tensor],
                                                  torch.Tensor]] = None):
    """Build the train step over `model` (the compute copy that
    make_train_state prepared; called as model(x, t, y, hint)).

    batch: dict with gt_latent [B, F, h, w, 4], lq_latent [B, F, h, w, 4],
    y [B, L, C], optional gt_pixels [B, F, H, W, 3] (needed for the
    frequency loss). The timesteps and the noise are drawn from
    `generator`, unless given as `t` [B] and `noise` (tests replay the JAX
    draws through them).

      train_step(state, batch, generator, t=, noise=) -> (state, metrics)
      train_step.loss_and_grads(batch, generator, t=, noise=) -> metrics;
          the gradients stay in the trainable parameters' .grad
      train_step.preview_x0(batch, generator, t_fixed=499) -> pixels
    """
    live = {n: p for n, p in model.named_parameters() if n in tx.names}

    def loss_and_grads(batch, generator: Optional[torch.Generator] = None,
                       *, t: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None):
        gt = batch['gt_latent'].float()
        if t is None:
            t = torch.randint(0, cfg.num_timesteps, (gt.shape[0],),
                              generator=generator, device=gt.device)
        if noise is None:
            noise = torch.randn(gt.shape, generator=generator,
                                device=gt.device)
        for p in live.values():
            p.grad = None
        noised = diffuse(tables, gt, t, noise)
        v_pred = model(noised, t, batch['y'], batch['lq_latent'])
        v_target = get_velocity(tables, gt, noised, t)
        pred_pixels = gt_pixels = None
        if cfg.freq_loss and vae_decode is not None and 'gt_pixels' in batch:
            pred_x0 = get_x0(tables, v_pred.float(), noised, t)
            with torch.set_grad_enabled(cfg.freq_grad):
                pred_pixels = vae_decode(pred_x0 if cfg.freq_grad
                                         else pred_x0.detach())
            gt_pixels = batch['gt_pixels']
        loss, metrics = star_sr_loss(v_pred, v_target, t, pred_pixels,
                                     gt_pixels, freq_grad=cfg.freq_grad)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics['grad_norm'] = global_norm(
            p.grad for p in live.values() if p.grad is not None)
        return metrics

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None):
        metrics = loss_and_grads(batch, generator, t=t, noise=noise)
        grads = {n: torch.zeros_like(state.params[n]) if p.grad is None
                 else p.grad for n, p in live.items()}
        metrics['grad_norm'] = tx.update(grads, state.step)
        with torch.no_grad():
            for n, p in live.items():
                p.grad = None
                p.copy_(state.params[n])
        ema = state.ema_params
        if cfg.ema_decay > 0 and ema is not None:
            ema = update_ema(ema, state.params, cfg.ema_decay)
        return TrainState(state.step + 1, state.params, state.opt_state,
                          ema), metrics

    @torch.no_grad()
    def preview_x0(batch, generator: Optional[torch.Generator] = None,
                   t_fixed: int = 499):
        """One-shot denoise of the batch at a fixed t -> predicted pixels
        (the latents when there is no vae_decode)."""
        gt = batch['gt_latent'].float()
        t = torch.full((gt.shape[0],), t_fixed, dtype=torch.long,
                       device=gt.device)
        noise = torch.randn(gt.shape, generator=generator, device=gt.device)
        noised = diffuse(tables, gt, t, noise)
        v = model(noised, t, batch['y'], batch['lq_latent'])
        x0 = get_x0(tables, v.float(), noised, t)
        return vae_decode(x0) if vae_decode is not None else x0

    train_step.loss_and_grads = loss_and_grads
    train_step.preview_x0 = preview_x0
    return train_step
