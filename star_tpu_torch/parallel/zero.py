"""ZeRO-1: the AdamW moments split over the mesh's 'data' axis
(counterpart of star_tpu/parallel/zero.py).

Each fp32 master is split along its first dim that the data size divides
(kept whole when none does, the rule of the JAX `_shardable_axis`); a rank
holds its part of the master as the parameter its AdamW steps, so it
holds only that part's moments. After the step the parts are all-gathered
into the whole masters. AdamW is elementwise, so the result is the
replicated optimizer's, bit for bit, given the same gradients.
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import AXIS_DATA, Mesh, all_gather_cat


def _shardable_axis(shape, n: int) -> Optional[int]:
    for ax, dim in enumerate(shape):
        if dim % n == 0 and dim >= n:
            return ax
    return None


def zero_part(t: torch.Tensor, ax: Optional[int], mesh: Mesh,
              axis: str = AXIS_DATA) -> torch.Tensor:
    """This rank's part of t along ax (a view; t itself when ax is None)."""
    if ax is None:
        return t
    n, r = mesh.size(axis), mesh.index(axis)
    size = t.shape[ax] // n
    return t.narrow(ax, r * size, size)


def zero_gather(part: torch.Tensor, ax: Optional[int], mesh: Mesh,
                axis: str = AXIS_DATA) -> torch.Tensor:
    """The whole tensor from every rank's part (the inverse of zero_part)."""
    if ax is None:
        return part
    return all_gather_cat(part, mesh, axis, ax)


def shard_opt_state(tx, mesh: Mesh, axis: str = AXIS_DATA):
    """Split the optimizer's AdamW moments over `axis` (the trainer's
    Optimizer; its moments so far carried over); returns it."""
    tx.shard(mesh, axis)
    return tx


def opt_state_memory_bytes(tx) -> int:
    """The bytes of this rank's own optimizer state."""
    return sum(v.numel() * v.element_size()
               for st in tx.adamw.state.values() for v in st.values()
               if torch.is_tensor(v))
