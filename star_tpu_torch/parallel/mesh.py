"""The rank mesh and its named axes (counterpart of
star_tpu/parallel/mesh.py).

One Mesh carries three named axes over the processes of a
torch.distributed world, one process a card:

  data    — batch and denoiser chunk windows (DP, with ZeRO-1 moments)
  tensor  — attention heads and MLP inner dims (Megatron TP)
  context — the causal VAE's time axis (CP) and the DiT's sequence
            (Ulysses SP)

Ranks are laid out as np.arange(n).reshape(data, tensor, context), the
device order of the JAX make_mesh, and each line of ranks along an axis
gets its own process group. The collectives are written out here (XLA
inserts them from sharding annotations in the JAX package); each goes
through `collective`, which refuses a tensor whose device the group's
backend does not take (NCCL takes CUDA tensors, gloo CPU ones) and never
catches a failure.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

AXIS_DATA = 'data'
AXIS_TENSOR = 'tensor'
AXIS_CONTEXT = 'context'
AXES = (AXIS_DATA, AXIS_TENSOR, AXIS_CONTEXT)


class P(tuple):
    """A partition spec (jax.sharding.PartitionSpec's counterpart): for
    each tensor dim, the mesh axis it is split over, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f'P{tuple.__repr__(self)}'


class Mesh:
    """data x tensor x context over the world's first data*tensor*context
    ranks. In an initialised world every axis has a process group, one of
    a single rank included (its collectives then run, on one rank);
    without one (one process) no axis has a group and the collectives
    return their input."""

    def __init__(self, data: int = 1, tensor: int = 1, context: int = 1,
                 ranks: Optional[np.ndarray] = None):
        self.shape = {AXIS_DATA: data, AXIS_TENSOR: tensor,
                      AXIS_CONTEXT: context}
        n = data * tensor * context
        self.devices = (np.arange(n) if ranks is None
                        else np.asarray(ranks)).reshape(data, tensor, context)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n > world:
            raise ValueError(f'a {data}x{tensor}x{context} mesh needs {n} '
                             f'processes; the world has {world}')
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(self.devices == self.rank)
        self.coords = dict(zip(AXES, where[0])) if len(where) else None
        self.groups: dict[str, Optional[dist.ProcessGroup]] = {}
        self.group_ranks: dict[str, list[int]] = {}
        for i, axis in enumerate(AXES):
            self.groups[axis] = None
            self.group_ranks[axis] = [self.rank]
            if not dist.is_initialized():
                continue
            # every rank makes every group, in one order (new_group is
            # collective over the world)
            lines = np.moveaxis(self.devices, i, -1).reshape(
                -1, self.shape[axis])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self.groups[axis] = g
                    self.group_ranks[axis] = [int(r) for r in line]

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return 0 if self.coords is None else int(self.coords[axis])

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]


def make_mesh(data: int = 1, tensor: int = 1, context: int = 1) -> Mesh:
    return Mesh(data, tensor, context)


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1, 1)


def replicated(mesh: Mesh) -> P:
    """The spec of a tensor held whole on every rank."""
    return P()


def data_sharding(mesh: Mesh, rank: int, axis: int = 0) -> P:
    """The spec of a rank-`rank` tensor split over 'data' along `axis`."""
    spec = [None] * rank
    spec[axis] = AXIS_DATA
    return P(*spec)


# ------------------------------------------------------------- collectives


def collective(x: torch.Tensor, group) -> None:
    """Refuse a tensor the group's backend does not take: NCCL takes CUDA
    tensors, gloo CPU ones. There is no fallback to another backend or to
    the host."""
    backend = dist.get_backend(group)
    want = 'cuda' if backend == 'nccl' else 'cpu'
    if x.device.type != want:
        raise ValueError(f'a {x.device.type} tensor handed to a {backend} '
                         f'group; {backend} takes {want} tensors')


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over the axis' group (a no-op without one); returns x."""
    g = mesh.group(axis)
    if g is not None:
        collective(x, g)
        dist.all_reduce(x, op=op, group=g)
    return x


def all_gather_cat(x: torch.Tensor, mesh: Mesh, axis: str,
                   dim: int = 0) -> torch.Tensor:
    """Each rank's x along `axis`, concatenated along `dim` in rank
    order."""
    g = mesh.group(axis)
    if g is None:
        return x
    x = x.contiguous()
    collective(x, g)
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, x, group=g)
    return torch.cat(parts, dim=dim)


def data_rows(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 0
              ) -> torch.Tensor:
    """This rank's rows of a tensor that holds the global batch along
    `dim`: rank r of n keeps rows r*b:(r+1)*b, as NamedSharding(mesh,
    P('data')) places them."""
    if mesh is None or mesh.size(AXIS_DATA) == 1:
        return x
    n, r = mesh.size(AXIS_DATA), mesh.index(AXIS_DATA)
    b = x.shape[dim] // n
    assert b * n == x.shape[dim], (x.shape, n)
    return x.narrow(dim, r * b, b)


def gather_data_rows(x: torch.Tensor, mesh: Optional[Mesh],
                     dim: int = 0) -> torch.Tensor:
    """The inverse of data_rows: the global batch on every rank."""
    if mesh is None:
        return x
    return all_gather_cat(x, mesh, AXIS_DATA, dim)


def draw_rows(draw, shape, mesh: Optional[Mesh]) -> torch.Tensor:
    """draw(global shape) for the global batch of a local `shape`, and this
    rank's rows of it: the draws, and the generator's state after them,
    are those of one process at the global batch."""
    n = 1 if mesh is None else mesh.size(AXIS_DATA)
    return data_rows(draw((shape[0] * n,) + tuple(shape[1:])), mesh)
