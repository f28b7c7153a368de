"""Ulysses sequence-parallel attention (counterpart of
star_tpu/parallel/ulysses.py).

Each rank of the context group holds q/k/v [B, S/P, H, D]; an all-to-all
regroups them to [B, S, H/P, D] (the whole sequence, a subset of the
heads), the attention runs locally, and the inverse all-to-all restores
[B, S/P, H, D]. The local attention is the packed entry point
(ops/attention.dot_product_attention_packed): kernel K1 on the card, its
plain version on the CPU. A sequence that P does not divide is padded to
the multiple and the pad tail is masked through K1's own kv_valid.
"""

from __future__ import annotations


import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.attention import dot_product_attention_packed
from .mesh import AXIS_CONTEXT, Mesh, collective


class _AllToAll(torch.autograd.Function):
    """[B, S_loc, H, D] -> [B, S_loc * P, H / P, D] over `group` (split the
    heads, gather the sequence); the inverse with inverse=True. Its
    gradient is the other direction."""

    @staticmethod
    def forward(ctx, x, group, inverse: bool):
        ctx.group, ctx.inverse = group, inverse
        return _a2a(x, group, inverse)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g.contiguous(), ctx.group, not ctx.inverse), None, None


def _a2a(x: torch.Tensor, group, inverse: bool) -> torch.Tensor:
    n = dist.get_world_size(group)
    b, s, h, d = x.shape
    if not inverse:           # chunk i of the heads goes to rank i
        send = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    else:                     # chunk i of the sequence goes to rank i
        send = x.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4)
    send = send.contiguous()
    collective(send, group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j]: what rank j sent
    if not inverse:           # [P, B, S_loc, H/P, D] -> [B, P*S_loc, ...]
        return recv.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, scale: float | None = None,
                      kv_valid: int | None = None,
                      prescaled: bool = False) -> torch.Tensor:
    """q/k/v: this rank's rows [B, S/P, H, D] of a sequence of S = P * S/P
    rows (rank order), split over `group` (a Mesh's context group, or None
    for one rank). H must be a multiple of P. Keys at or beyond kv_valid
    (a global row index) get no weight. Returns this rank's rows of the
    output [B, S/P, H, D]."""
    if isinstance(group, Mesh):
        group = group.group(AXIS_CONTEXT)
    n = 1 if group is None else dist.get_world_size(group)
    b, s_loc, h, d = q.shape
    assert h % n == 0, (q.shape, n)
    if group is not None:
        q, k, v = (_AllToAll.apply(t.contiguous(), group, False)
                   for t in (q, k, v))
    s = q.shape[1]
    hl = q.shape[2]
    pack = lambda t: t.reshape(b, s, hl * d)
    out = dot_product_attention_packed(
        pack(q), pack(k), pack(v), hl, scale=scale,
        kv_valid=kv_valid if kv_valid is not None and kv_valid < s else None,
        prescaled=prescaled).reshape(b, s, hl, d)
    if group is not None:
        out = _AllToAll.apply(out, group, True)
    return out


def ulysses_attention_global(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, group,
                             scale: float | None = None,
                             kv_valid: int | None = None,
                             prescaled: bool = False) -> torch.Tensor:
    """The JAX function's global view: q/k/v [B, S, H, D] whole on every
    rank, S of any length. Pads S to a multiple of P (the tail masked),
    runs this rank's rows through ulysses_attention and gathers the
    output rows back: [B, S, H, D] on every rank."""
    if isinstance(group, Mesh):
        group = group.group(AXIS_CONTEXT)
    n = 1 if group is None else dist.get_world_size(group)
    r = 0 if group is None else dist.get_rank(group)
    s = q.shape[1]
    valid = s if kv_valid is None else min(kv_valid, s)
    s_pad = -(-s // n) * n
    if s_pad != s:
        pad = lambda t: F.pad(t, (0, 0, 0, 0, 0, s_pad - s))
        q, k, v = pad(q), pad(k), pad(v)
    rows = s_pad // n
    part = lambda t: t[:, r * rows:(r + 1) * rows]
    out = ulysses_attention(part(q), part(k), part(v), group, scale=scale,
                            kv_valid=valid if valid < s_pad else None,
                            prescaled=prescaled)
    if group is not None:
        out = out.contiguous()
        collective(out, group)
        parts = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(parts, out, group=group)
        out = torch.cat(parts, dim=1)
    return out[:, :s]
