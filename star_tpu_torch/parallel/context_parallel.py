"""Context-parallel primitives for the causal 3D VAE (counterpart of
star_tpu/parallel/context_parallel.py): the time axis split over the ranks
of a context group, a halo exchange for the causal time convs and gathered
GroupNorm statistics.

Each rank holds its time shard [B, T/P, H, W, C]. The halo (the previous
rank's last kt-1 frames) travels around a ring of dist.batch_isend_irecv:
every rank posts its send and its receive together, so no two ranks wait
on each other; rank 0 discards what it receives and replicates its first
frame, the causal start. The statistics are fp32 sums, all-reduced. The
group is a torch.distributed process group, or None for one rank.

The dead-slot layout (the full VAE end to end): a clip of 1 + P*k frames
is held as k+1 slots a rank; rank 0's are all real (frames 0..k), rank
i > 0 holds its k frames and one trailing dead slot. Dead slots run
through the spatial ops as garbage and are left out of the GroupNorm
statistics, skipped by the halo and regenerated by the temporal
resamplers, whose pairs then never straddle two ranks. k must stay at
least kt-1 = 2 at the deepest temporal level.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import AXIS_CONTEXT, Mesh, collective


def _group(group):
    return group.group(AXIS_CONTEXT) if isinstance(group, Mesh) else group


def rank_and_size(group) -> tuple[int, int]:
    """(this rank's index, the rank count) of a context group, a Mesh's
    context axis, or None (one rank)."""
    group = _group(group)
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def is_first(group) -> bool:
    return rank_and_size(group)[0] == 0


def ring_from_previous(tail: torch.Tensor, group) -> torch.Tensor:
    """What the previous rank of the ring sent (each rank sends `tail` to
    the next); with one rank, `tail` itself."""
    group = _group(group)
    r, n = rank_and_size(group)
    if n == 1:
        return tail
    tail = tail.contiguous()
    collective(tail, group)
    got = torch.empty_like(tail)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, tail, nxt, group),
        dist.P2POp(dist.irecv, got, prv, group)])
    for q in reqs:
        q.wait()
    return got


def _psum32(x: torch.Tensor, group) -> torch.Tensor:
    x = x.float().contiguous()
    if group is not None:
        collective(x, group)
        dist.all_reduce(x, group=group)
    return x


def _halo_from_previous(x_local: torch.Tensor, kt: int, group
                        ) -> torch.Tensor:
    """The previous rank's last kt-1 frames before x_local (rank 0: its
    first frame replicated)."""
    prev_tail = ring_from_previous(x_local[:, -(kt - 1):], group)
    if is_first(group):
        front = x_local[:, :1].expand(-1, kt - 1, *x_local.shape[2:])
    else:
        front = prev_tail
    return torch.cat([front, x_local], dim=1)


def cp_causal_conv3d(x_local: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, group) -> torch.Tensor:
    """The causal 3D conv over this rank's time shard [B, T/P, H, W, C]
    (weight [Cout, Cin, kt, kh, kw], the port's CausalConv3d layout):
    equal, shard by shard, to the one-rank conv with the first frame
    replicated in front."""
    kt, kh, kw = weight.shape[2:]
    xp = _halo_from_previous(x_local, kt, _group(group)) if kt > 1 \
        else x_local
    y = F.conv3d(xp.permute(0, 4, 1, 2, 3), weight.to(xp.dtype),
                 bias.to(xp.dtype), 1, (0, kh // 2, kw // 2))
    return y.permute(0, 2, 3, 4, 1)


def _apply_stats(x, s1, s2, cnt, scale, bias, num_groups, eps, shape):
    c = shape[-1]
    mean = s1 / cnt
    var = s2 / cnt - mean.square()
    inv = torch.rsqrt(var + eps)
    a = inv * scale.float().reshape(num_groups, c // num_groups)
    bb = bias.float().reshape(num_groups, c // num_groups) - mean * a
    return (x.float() * a + bb).reshape(shape).to(x.dtype)


def cp_group_norm(x_local: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, group, num_groups: int = 32,
                  eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm of the whole time-sharded video: the statistics are fp32
    sums all-reduced over the group (ContextParallelGroupNorm)."""
    group = _group(group)
    b, c = x_local.shape[0], x_local.shape[-1]
    xg = x_local.reshape(b, -1, num_groups, c // num_groups)
    s1 = _psum32(xg.float().sum(dim=(1, 3), keepdim=True), group)
    s2 = _psum32(xg.float().square().sum(dim=(1, 3), keepdim=True), group)
    cnt = float(xg.shape[1] * rank_and_size(group)[1] * (c // num_groups))
    return _apply_stats(xg, s1, s2, cnt, scale, bias, num_groups, eps,
                        x_local.shape)


# ------------------------------------------------------- the dead-slot layout


def cp_pad_to_slots(x: torch.Tensor, n_ranks: int) -> torch.Tensor:
    """[B, 1+P*k, ...] -> [B, P*(k+1), ...]: the dead-slot layout."""
    t = x.shape[1]
    assert (t - 1) % n_ranks == 0, (t, n_ranks)
    k = (t - 1) // n_ranks
    chunks = [x[:, :k + 1]]
    for i in range(1, n_ranks):
        c = x[:, 1 + i * k: 1 + (i + 1) * k]
        chunks.append(torch.cat([c, torch.zeros_like(c[:, :1])], dim=1))
    return torch.cat(chunks, dim=1)


def cp_unpad_from_slots(x: torch.Tensor, n_ranks: int) -> torch.Tensor:
    """The inverse of cp_pad_to_slots on the gathered output."""
    slots = x.shape[1] // n_ranks
    k = slots - 1
    parts = [x[:, :slots]]
    for i in range(1, n_ranks):
        parts.append(x[:, i * slots: i * slots + k])
    return torch.cat(parts, dim=1)


def cp_slot_halo_front(x_local: torch.Tensor, kt: int, group
                       ) -> torch.Tensor:
    """The kt-1 front frames of a causal time conv: rank 0 replicates the
    true first frame, rank i receives the previous rank's last kt-1 REAL
    frames."""
    group = _group(group)
    m = kt - 1
    k = x_local.shape[1] - 1
    assert k >= m, (f'{k} real frames a rank at this level; a causal conv '
                    f'of {kt} taps needs {m}: give the clip more frames')
    first = is_first(group)
    start = k + 1 - m if first else k - m
    prev_tail = ring_from_previous(x_local[:, start:start + m], group)
    if first:
        return x_local[:, :1].expand(-1, m, *x_local.shape[2:])
    return prev_tail


def cp_slot_real_mask(x_local: torch.Tensor, group) -> torch.Tensor:
    """[T_slots] fp32 mask of this rank's real (not dead) slots."""
    mask = torch.ones(x_local.shape[1], dtype=torch.float32,
                      device=x_local.device)
    if not is_first(group):
        mask[-1] = 0.0
    return mask


def cp_slot_group_norm(x_local: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, num_groups: int, eps: float,
                       group) -> torch.Tensor:
    """GroupNorm over the dead-slot layout: the statistics of the whole
    clip's real slots (the one-rank full-clip GroupNorm)."""
    group = _group(group)
    b, tl, c = x_local.shape[0], x_local.shape[1], x_local.shape[-1]
    mask = cp_slot_real_mask(x_local, group)
    xg = x_local.reshape(b, tl, -1, num_groups, c // num_groups)
    w = mask[None, :, None, None, None]
    x32 = xg.float()
    s1 = _psum32((x32 * w).sum(dim=(1, 2, 4), keepdim=True), group)
    s2 = _psum32((x32.square() * w).sum(dim=(1, 2, 4), keepdim=True), group)
    cnt = _psum32(mask.sum(), group) * xg.shape[2] * xg.shape[4]
    return _apply_stats(xg, s1, s2, cnt, scale, bias, num_groups, eps,
                        x_local.shape)


def _pool_pairs_time(z: torch.Tensor) -> torch.Tensor:
    b, t = z.shape[0], z.shape[1]
    return z.reshape(b, t // 2, 2, *z.shape[2:]).mean(dim=2)


def cp_slot_pool_time(x_local: torch.Tensor, group) -> torch.Tensor:
    """The first-frame-special 2x temporal average pool of the whole clip
    over the dead-slot layout ([k+1] slots -> [k/2+1])."""
    k = x_local.shape[1] - 1
    assert k % 2 == 0, k
    if is_first(group):
        return torch.cat([x_local[:, :1], _pool_pairs_time(x_local[:, 1:])],
                         dim=1)
    return torch.cat([_pool_pairs_time(x_local[:, :k]),
                      torch.zeros_like(x_local[:, :1])], dim=1)


def _repeat_time(z: torch.Tensor, r: int) -> torch.Tensor:
    return z.repeat_interleave(r, dim=1)


def cp_slot_upsample_time(x_local: torch.Tensor, group) -> torch.Tensor:
    """The first-frame-special 2x temporal nearest upsample over the
    dead-slot layout ([k+1] slots -> [2k+1])."""
    k = x_local.shape[1] - 1
    if is_first(group):
        return torch.cat([x_local[:, :1], _repeat_time(x_local[:, 1:], 2)],
                         dim=1)
    return torch.cat([_repeat_time(x_local[:, :k], 2),
                      torch.zeros_like(x_local[:, :1])], dim=1)


def cp_slot_repeat_zq(zq_local: torch.Tensor, r: int,
                      group) -> torch.Tensor:
    """The temporal part of SpatialNorm3D's zq resize over the dead-slot
    layout: the first frame kept single, the others repeated r times."""
    if r == 1:
        return zq_local
    kz = zq_local.shape[1] - 1
    if is_first(group):
        return torch.cat([zq_local[:, :1], _repeat_time(zq_local[:, 1:], r)],
                         dim=1)
    return torch.cat([_repeat_time(zq_local[:, :kz], r),
                      torch.zeros_like(zq_local[:, :1])], dim=1)


def cp_rank_slots(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's slots of a whole dead-slot tensor [B, P*(k+1), ...]."""
    group = _group(group)
    r, n = rank_and_size(group)
    s = x.shape[1] // n
    return x[:, r * s:(r + 1) * s]


def cp_gather_slots(x_local: torch.Tensor, group) -> torch.Tensor:
    """Every rank's slots, in rank order, on every rank."""
    group = _group(group)
    if group is None:
        return x_local
    x_local = x_local.contiguous()
    collective(x_local, group)
    parts = [torch.empty_like(x_local)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x_local, group=group)
    return torch.cat(parts, dim=1)

