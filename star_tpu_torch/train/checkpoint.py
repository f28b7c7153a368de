"""Train-state checkpoints as torch files (the port's counterpart of the
orbax CheckpointManager that star_tpu's training CLIs use, with the same
two options: max_to_keep and save_interval_steps).

A checkpoint is `{directory}/step_{step:08d}.pt`, one torch file holding
the step, the fp32 masters, the AdamW state (moments and counts), the EMA
and the state of the run's torch.Generator (orbax's holds no key: the JAX
CLIs restart theirs on resume), written to a temporary name and renamed, so a crash leaves no partial
file under a step's name. The decision to save follows orbax's default
policy: a step is saved when it is a multiple of save_interval_steps or no
checkpoint exists yet, and never at or below the latest saved step; after
a save, all but the newest max_to_keep are deleted.

Several processes (parallel/): every rank calls save and restore. A save
gathers the ZeRO-split moments and the tensor-split masters, moments and
EMA first, so the file is the one a single process writes; only rank 0
writes it, and the decision to save is made from the latest step this
manager saw (read once from the directory, then its own saves), the same
on every rank. A restore splits them again.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ..parallel.sharding import shard
from .trainer import TrainState

_NAME = re.compile(r'^step_(\d+)\.pt$')


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.writer = not dist.is_initialized() or dist.get_rank() == 0
        if self.writer:
            os.makedirs(directory, exist_ok=True)
        self.latest = self.latest_step() if os.path.isdir(directory) \
            else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f'step_{step:08d}.pt')

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest
        if latest is not None and latest >= step:
            return False
        return latest is None or step % self.save_interval_steps == 0

    def save(self, step: int, state: TrainState,
             generator: Optional[torch.Generator] = None) -> bool:
        """Write `state` (and `generator`'s state) as step `step` if the
        policy says so; returns whether it did."""
        if not self.should_save(step):
            return False
        tx = state.opt_state
        whole = lambda d: None if d is None else \
            {n: tx.full(n, t) for n, t in d.items()}
        blob = {'step': int(state.step), 'params': whole(state.params),
                'opt': tx.full_state_dict(),
                'ema': whole(state.ema_params),
                'generator': None if generator is None
                else generator.get_state()}
        self.latest = step
        if not self.writer:
            return True
        tmp = self.path(step) + f'.{os.getpid()}.tmp'
        torch.save(blob, tmp)
        os.replace(tmp, self.path(step))
        if self.max_to_keep:            # None keeps every checkpoint
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        return True

    def restore(self, step: int, state: TrainState,
                model: Optional[nn.Module] = None,
                generator: Optional[torch.Generator] = None) -> TrainState:
        """Load step `step` into `state` in place (masters, AdamW state),
        given the module its trainable parameters from the masters, given
        the generator its saved state; returns the restored TrainState."""
        blob = torch.load(self.path(step), map_location='cpu',
                          weights_only=True)
        tx = state.opt_state
        part = lambda n, t: shard(n, t, tx.tp_plan, tx.tp_mesh) \
            if tx.tp_plan else t
        named = dict(model.named_parameters()) if model is not None else {}
        with torch.no_grad():
            for n, m in state.params.items():
                m.copy_(part(n, blob['params'][n]))
                if n in named:
                    named[n].copy_(m)
        tx.load_full_state_dict(blob['opt'])
        if generator is not None and blob['generator'] is not None:
            generator.set_state(blob['generator'])
        ema = blob['ema']
        if ema is not None:
            ema = {n: part(n, e).to(state.params[n].device)
                   for n, e in ema.items()}
        return TrainState(blob['step'], state.params, state.opt_state, ema)
