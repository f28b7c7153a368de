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

Parallel (parallel/): under a mesh with a 'data' group each rank takes
its rows of the global batch, draws the timesteps and noise of the whole
global batch and keeps its rows (so the draws are one process's at the
global batch), and averages the gradients over 'data' before the
optimizer; the metrics are those of the global batch. ZeRO-1 (parallel.zero) splits
the AdamW moments over 'data'. A model split by parallel.shard_params
holds its rank's part of each split parameter, and so do the masters and
their moments; the global norm counts each element once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ..diffusion import DiffusionTables, diffuse, get_velocity, get_x0
from ..models.unet.blocks import DropoutMasks
from ..parallel.mesh import (AXIS_DATA, AXIS_TENSOR, Mesh, all_reduce,
                             draw_rows, gather_data_rows)
from ..parallel.sharding import shard, unshard
from ..parallel.zero import _shardable_axis, zero_gather, zero_part
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


def trainable_mask(model: nn.Module,
                   trainable: Callable[[str], bool] = is_trainable
                   ) -> dict[str, bool]:
    """Parameter name (the flax path with '.') -> trainable."""
    return {n: trainable(n) for n, _ in model.named_parameters()}


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
    learning rate lr * min(count, n) / n at update `count` (0 first).

    The norm is that of the whole gradient, before any ZeRO part steps.
    `shard` (parallel.zero.shard_opt_state) makes the AdamW step this
    rank's part of each master (a view), then all-gathers the parts;
    `tp_plan`/`tp_mesh` name the masters split by tensor parallelism."""

    def __init__(self, cfg: TrainConfig, params: dict[str, torch.Tensor]):
        self.cfg = cfg
        self.names = list(params)
        self.masters = params
        self.mesh, self.axis = None, AXIS_DATA
        self.zero_axes: dict = {n: None for n in self.names}
        self.tp_plan: dict = {}
        self.tp_mesh: Optional[Mesh] = None
        self.adamw = self._adamw(list(params.values()))

    def _adamw(self, tensors) -> torch.optim.AdamW:
        cfg = self.cfg
        return torch.optim.AdamW(
            tensors, lr=cfg.learning_rate,
            betas=(cfg.adam_beta1, cfg.adam_beta2), eps=cfg.adam_eps,
            weight_decay=cfg.weight_decay)

    def lr(self, count: int) -> float:
        n = self.cfg.warmup_steps
        return self.cfg.learning_rate * (min(count, n) / n if n else 1.0)

    def shard(self, mesh: Mesh, axis: str = AXIS_DATA) -> None:
        """ZeRO-1 over `axis`: from here on this rank steps (and holds the
        moments of) its part of each master."""
        full = self.full_state_dict()
        self.mesh, self.axis = mesh, axis
        n = mesh.size(axis)
        self.zero_axes = {k: _shardable_axis(self.masters[k].shape, n)
                          for k in self.names}
        self.adamw = self._adamw([zero_part(self.masters[k],
                                            self.zero_axes[k], mesh, axis)
                                  for k in self.names])
        self.load_full_state_dict(full)

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The norm of the whole gradient (name -> gradient, None for
        none): with tensor-split masters their squares are summed over
        'tensor', each element counted once."""
        named = [(n, g) for n, g in grads.items() if g is not None]
        if not self.tp_plan:
            return global_norm(g for _, g in named)
        zero = torch.zeros((), device=named[0][1].device)
        sq = lambda split: sum(
            (torch.linalg.vector_norm(g.float()).square() for n, g in named
             if (n in self.tp_plan) == split), zero)
        return torch.sqrt(sq(False) + all_reduce(sq(True), self.tp_mesh,
                                                 AXIS_TENSOR))

    def update(self, grads: dict[str, torch.Tensor],
               count: int) -> torch.Tensor:
        """One step of the masters in place; returns the global norm of
        `grads` before clipping."""
        gs = [grads[n] for n in self.names]
        norm = self.global_norm(grads)
        max_norm = self.cfg.max_grad_norm
        factor = torch.where(norm < max_norm, torch.ones_like(norm),
                             max_norm / norm)
        for n, p, g in zip(self.names, self.adamw.param_groups[0]['params'],
                           gs):
            p.grad = zero_part(g.float(), self.zero_axes[n], self.mesh,
                               self.axis) * factor
        self.adamw.param_groups[0]['lr'] = self.lr(count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        for n, p in zip(self.names, self.adamw.param_groups[0]['params']):
            if self.zero_axes[n] is not None:
                self.masters[n].copy_(zero_gather(p.contiguous(),
                                                  self.zero_axes[n],
                                                  self.mesh, self.axis))
        return norm

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A master-shaped tensor of this rank made whole over 'tensor'."""
        return unshard(name, t, self.tp_plan, self.tp_mesh) \
            if self.tp_plan else t

    def full_state_dict(self) -> dict:
        """The AdamW state as one process holding every master whole would
        have it: the moments gathered over 'data' (ZeRO) and 'tensor'."""
        sd = self.adamw.state_dict()
        state = {}
        for i, st in sd['state'].items():
            n = self.names[i]
            state[i] = {k: v if k == 'step' else self.full(
                n, zero_gather(v.contiguous(), self.zero_axes[n],
                               self.mesh, self.axis))
                for k, v in st.items()}
        return {'state': state, 'param_groups': sd['param_groups']}

    def load_full_state_dict(self, sd: dict) -> None:
        """The inverse of full_state_dict: this rank's parts loaded."""
        state = {}
        for i, st in sd['state'].items():
            n = self.names[i]
            state[i] = {k: v if k == 'step' else zero_part(
                shard(n, v, self.tp_plan, self.tp_mesh)
                if self.tp_plan else v,
                self.zero_axes[n], self.mesh, self.axis).clone()
                for k, v in st.items()}
        self.adamw.load_state_dict({'state': state,
                                    'param_groups': sd['param_groups']})


def make_optimizer(cfg: TrainConfig,
                   params: dict[str, torch.Tensor]) -> Optimizer:
    return Optimizer(cfg, params)


def make_train_state(cfg: TrainConfig, model: nn.Module,
                     trainable: Callable[[str], bool] = is_trainable
                     ) -> tuple[TrainState, Optimizer]:
    """fp32 masters of the model's trainable set (the parameters whose
    names `trainable` accepts, from their current values), the optimizer
    over them, and the model made ready to train: frozen parameters
    without grad, trainable ones in the compute dtype (the frozen set's
    dtype) with grad."""
    mask = trainable_mask(model, trainable)
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
    # the masters of parameters split by parallel.shard_params
    tx.tp_plan = {n: v for n, v in getattr(model, 'tp_plan', {}).items()
                  if n in masters}
    tx.tp_mesh = getattr(model, 'tp_mesh', None)
    ema = init_ema(masters) if cfg.ema_decay > 0 else None
    return TrainState(0, masters, tx, ema), tx


def apply_update(cfg, state: TrainState, tx: Optimizer,
                 live: dict[str, nn.Parameter], metrics: dict
                 ) -> tuple[TrainState, dict]:
    """Step the masters by the gradients in the module's trainable
    parameters `live` (zero where none reached), copy them back into the
    module, update the EMA; metrics['grad_norm'] becomes the optimizer's
    pre-clip norm."""
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


def data_parallel(mesh: Optional[Mesh]) -> bool:
    """The step runs the data-parallel path: the mesh has a 'data' group
    (of one rank or more)."""
    return mesh is not None and mesh.group(AXIS_DATA) is not None


def mean_grads_over_data(live: dict, mesh: Optional[Mesh]) -> None:
    """Each gradient becomes its mean over the 'data' ranks."""
    if data_parallel(mesh):
        for p in live.values():
            if p.grad is not None:
                all_reduce(p.grad, mesh, AXIS_DATA).div_(mesh.size(AXIS_DATA))


def make_train_step(cfg: TrainConfig, model: nn.Module,
                    tables: DiffusionTables, tx: Optimizer,
                    vae_decode: Optional[Callable[[torch.Tensor],
                                                  torch.Tensor]] = None,
                    mesh: Optional[Mesh] = None,
                    deterministic: bool = True):
    """Build the train step over `model` (the compute copy that
    make_train_state prepared; called as model(x, t, y, hint)).

    batch: dict with gt_latent [B, F, h, w, 4], lq_latent [B, F, h, w, 4],
    y [B, L, C], optional gt_pixels [B, F, H, W, 3] (needed for the
    frequency loss): this rank's rows of the global batch under a mesh
    with a 'data' group. The timesteps and the noise are drawn from `generator`,
    unless given as `t` [B] and `noise` (tests replay the JAX draws
    through them). With deterministic=False the UNet's dropout is active,
    its masks drawn from `generator` too (or given as `dropout_masks`).

      train_step(state, batch, generator, t=, noise=) -> (state, metrics)
      train_step.loss_and_grads(batch, generator, t=, noise=) -> metrics;
          the gradients stay in the trainable parameters' .grad
      train_step.preview_x0(batch, generator, t_fixed=499) -> pixels
    """
    live = {n: p for n, p in model.named_parameters() if n in tx.names}
    dp = data_parallel(mesh)
    if dp and cfg.freq_grad:
        raise ValueError('freq_grad under data parallelism: the frequency '
                         'term is computed on the gathered batch, without '
                         'gradient')
    shard_of = (mesh.index(AXIS_DATA), mesh.size(AXIS_DATA)) if dp \
        else (0, 1)

    def loss_and_grads(batch, generator: Optional[torch.Generator] = None,
                       *, t: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       dropout_masks: Optional[DropoutMasks] = None):
        gt = batch['gt_latent'].float()
        if t is None:
            t = draw_rows(lambda s: torch.randint(
                0, cfg.num_timesteps, s, generator=generator,
                device=gt.device), gt.shape[:1], mesh)
        if noise is None:
            noise = draw_rows(lambda s: torch.randn(
                s, generator=generator, device=gt.device), gt.shape, mesh)
        for p in live.values():
            p.grad = None
        kw = {}
        if not deterministic:
            kw = dict(deterministic=False, dropout_masks=dropout_masks
                      or DropoutMasks(generator, shard=shard_of))
        noised = diffuse(tables, gt, t, noise)
        v_pred = model(noised, t, batch['y'], batch['lq_latent'], **kw)
        v_target = get_velocity(tables, gt, noised, t)
        pred_pixels = gt_pixels = None
        if cfg.freq_loss and vae_decode is not None and 'gt_pixels' in batch:
            pred_x0 = get_x0(tables, v_pred.float(), noised, t)
            with torch.set_grad_enabled(cfg.freq_grad):
                pred_pixels = vae_decode(pred_x0 if cfg.freq_grad
                                         else pred_x0.detach())
            gt_pixels = batch['gt_pixels']
        if dp:
            # the gradient of this rank's mean, averaged over the ranks, is
            # that of the global mean; the metrics are the global batch's
            loss, _ = star_sr_loss(v_pred, v_target, t)
            loss.backward()
            g = lambda x: None if x is None else \
                gather_data_rows(x.detach(), mesh)
            with torch.no_grad():
                _, metrics = star_sr_loss(g(v_pred), g(v_target), g(t),
                                          g(pred_pixels), g(gt_pixels))
        else:
            loss, metrics = star_sr_loss(v_pred, v_target, t, pred_pixels,
                                         gt_pixels, freq_grad=cfg.freq_grad)
            loss.backward()
        mean_grads_over_data(live, mesh)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics['grad_norm'] = tx.global_norm(
            {n: p.grad for n, p in live.items()})
        return metrics

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   dropout_masks: Optional[DropoutMasks] = None):
        metrics = loss_and_grads(batch, generator, t=t, noise=noise,
                                 dropout_masks=dropout_masks)
        return apply_update(cfg, state, tx, live, metrics)

    @torch.no_grad()
    def preview_x0(batch, generator: Optional[torch.Generator] = None,
                   t_fixed: int = 499):
        """One-shot denoise of the batch at a fixed t -> predicted pixels
        (the latents when there is no vae_decode)."""
        gt = batch['gt_latent'].float()
        t = torch.full((gt.shape[0],), t_fixed, dtype=torch.long,
                       device=gt.device)
        noise = draw_rows(lambda s: torch.randn(s, generator=generator,
                                                device=gt.device),
                          gt.shape, mesh)
        noised = diffuse(tables, gt, t, noise)
        v = model(noised, t, batch['y'], batch['lq_latent'])
        x0 = get_x0(tables, v.float(), noised, t)
        return vae_decode(x0) if vae_decode is not None else x0

    train_step.loss_and_grads = loss_and_grads
    train_step.preview_x0 = preview_x0
    return train_step
