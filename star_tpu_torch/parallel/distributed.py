"""Multi-process start and the hybrid mesh layout (counterpart of
star_tpu/parallel/distributed.py).

One process a card. init_distributed reads torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT) or takes the
coordinator `host:port` as a tcp:// rendezvous, picks NCCL for a CUDA
device and gloo for the CPU, and binds the process to its LOCAL_RANK card.
The hybrid mesh keeps each tensor/context group inside one host's local
ranks, so that TP and CP collectives ride NVLink and only the data axis
crosses hosts.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: torch.device | str = 'cuda') -> tuple[int, int]:
    """Start the process group when running multi-process; returns
    (process index, process count).

    The arguments fall back to torchrun's WORLD_SIZE and RANK, and the
    rendezvous to MASTER_ADDR:MASTER_PORT (which torchrun sets, for one
    process too). A single process with no coordinator is a no-op that
    returns (0, 1). NCCL for a CUDA `device`
    (the process bound to card LOCAL_RANK first), gloo for the CPU."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    world = num_processes if num_processes is not None \
        else int(env.get('WORLD_SIZE', 1))
    rank = process_id if process_id is not None else int(env.get('RANK', 0))
    if coordinator is None and 'MASTER_ADDR' in env:
        coordinator = f'{env["MASTER_ADDR"]}:{env.get("MASTER_PORT", 29500)}'
    if coordinator is None:
        if world > 1:
            raise ValueError(f'{world} processes need a rendezvous: pass '
                             '--coordinator host:port or start them with '
                             'torchrun')
        return 0, 1
    cuda = torch.device(device).type == 'cuda'
    if cuda:
        torch.cuda.set_device(int(env.get('LOCAL_RANK', 0)))
    dist.init_process_group('nccl' if cuda else 'gloo',
                            init_method=f'tcp://{coordinator}',
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=10))
    return rank, world


def local_world_size() -> int:
    """The processes of this host: torchrun's LOCAL_WORLD_SIZE, else the
    whole world (one host)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return int(os.environ.get('LOCAL_WORLD_SIZE', world))


def make_hybrid_mesh(data: int = -1, tensor: int = 1,
                     context: int = 1) -> Mesh:
    """A mesh whose 'data' axis spans hosts while tensor and context stay
    inside each host's local ranks (torchrun numbers a host's ranks
    contiguously). data=-1 takes every remaining rank."""
    per_host = local_world_size()
    n_total = dist.get_world_size() if dist.is_initialized() else 1
    inner = tensor * context
    assert per_host % inner == 0, (
        f'tensor*context={inner} must divide local device count {per_host} '
        f'so TP/CP collectives stay on ICI')
    if data == -1:
        data = n_total // inner
    assert data * inner <= n_total, (data, inner, n_total)
    return Mesh(data, tensor, context)
