"""Flash attention: kernels K1, K2 and K3
(counterpart of star_tpu/ops/flash_attention.py).

  K1 `flash_attention_packed`: q/k/v [B, S, H*D] natural layout, d=64,
     optional `kv_valid` dead-tail mask and `prescaled` q — the UNet's
     spatial self-attention (Pallas `_flash_packed_kernel`).
  K2 `flash_attention`: q/k/v [B, S, H, D], here d=512 single head — the
     SVD-VAE mid attention (Pallas `_flash_kernel`, forward).
  K2 `with_l` and K3, the training path of d=64 attention (both entry
     points): when grad mode is on and an input requires grad, the
     forward is the d=64 kernel writing the natural log-sum-exp of each
     row (`lse` [B, H, Sq]) and the backward is csrc/flash_bwd_sm90.cu,
     the recompute backward (Pallas `_flash_bwd`). The JAX package saves
     the fixed-reference denominators l instead; the gradient is the same
     function.

All three are wgmma kernels fed by TMA, warp-specialised, over
csrc/sm90.cuh: the d=64 forward (K1 and K2 `with_l`) is
csrc/flash_fwd_sm90.cu, the d=512 forward csrc/flash_fwd_d512_sm90.cu and
the backward csrc/flash_bwd_sm90.cu. Their launch arithmetic is
`k1_launch_plan`, `d512_launch_plan` and `k3_launch_plan`.

Every kernel runs for a CUDA tensor (or raises if it does not take the
input), and its plain PyTorch version for a CPU tensor. The plain forward
is the JAX package's `_xla_reference`: fp32 logits, fp32 softmax,
probabilities in the input dtype, fp32 accumulation. K2 at d=512 has no
backward: under grad its launcher raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils.profiling import annotate, spanned
from . import _build

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# launches of each kernel (plain ints; chip_smoke.py resets and reads them)
PACKED_LAUNCHES = 0   # K1, d=64
LSE_LAUNCHES = 0      # K2 `with_l`: the d=64 forward writing the lse
D512_LAUNCHES = 0     # K2, d=512
BWD_LAUNCHES = 0      # K3, d=64


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, return_lse: bool = False):
    """[B, Sq, H, D] x [B, Sk, H, D] -> [B, Sq, H, D] through materialised
    fp32 logits (the reference every flash kernel is held to); with
    `return_lse` also the natural log-sum-exp of the logits [B, H, Sq]."""
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum('bhqk,bkhd->bqhd', probs.float(), v.float())
    out = out.to(q.dtype)
    return (out, torch.logsumexp(logits, dim=-1)) if return_lse else out


def flash_attention_packed_plain(q, k, v, num_heads, scale, kv_valid=None,
                                 prescaled=False, return_lse=False):
    b, s, c = q.shape
    d = c // num_heads
    kv = k.shape[1] if kv_valid is None else min(kv_valid, k.shape[1])
    to4 = lambda t: t.reshape(t.shape[0], t.shape[1], num_heads, d)
    # a prescaled q carries scale*log2(e): logits*ln2 are natural-log logits
    res = attention_plain(to4(q), to4(k[:, :kv]), to4(v[:, :kv]),
                          LN2 if prescaled else scale, return_lse)
    if return_lse:
        return res[0].reshape(b, s, c), res[1]
    return res.reshape(b, s, c)


def flash_bwd_plain(q, k, v, o, lse, do, num_heads: int, scale: float):
    """K3's plain version. q/o/do [B, Sq, H*D], k/v [B, Sk, H*D] (already
    cut to the live keys), lse [B, H, Sq] natural, `scale` natural (ln 2
    for a prescaled q) -> (dq, dk, dv) in q's dtype and layout:
    P = exp(scale q k^T - lse), D = rowsum(dO o), dS = P (dO v^T - D);
    P and dS rounded to q.dtype before dV = P^T dO, dK = scale dS^T q,
    dQ = scale dS k, each accumulated in fp32. Heads and batch rows are
    independent, so it can run on any slice of them (chip_smoke.py runs it
    one (batch, head) at a time at 14400 tokens)."""
    b, sq, c = q.shape
    d = c // num_heads
    to4 = lambda t: t.reshape(t.shape[0], t.shape[1], num_heads, d).float()
    q4, k4, v4, o4, g4 = map(to4, (q, k, v, o, do))
    logits = torch.einsum('bqhd,bkhd->bhqk', q4, k4) * scale
    p = torch.exp(logits - lse.float()[..., None])
    dp = torch.einsum('bqhd,bkhd->bhqk', g4, v4)
    dvec = (g4 * o4).sum(-1).transpose(1, 2)[..., None]      # [B, H, Sq, 1]
    ds = p * (dp - dvec)
    p = p.to(q.dtype).float()
    ds = ds.to(q.dtype).float()
    dv = torch.einsum('bhqk,bqhd->bkhd', p, g4)
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, q4) * scale
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, k4) * scale
    flat = lambda t: t.reshape(t.shape[0], t.shape[1], c).to(q.dtype)
    return flat(dq), flat(dk), flat(dv)


# K1's tiles (csrc/flash_fwd_sm90.cu): 128 query rows a block in two
# consumer warpgroups of 64, 128 keys a tile, a 64-column head = one
# 128-byte swizzled row
K1_BQ, K1_BK, K1_D = 128, 128, 64
K1_THREADS = 384      # a producer warpgroup and two consumer warpgroups
# K2 at d=512 (csrc/flash_fwd_d512_sm90.cu): 64 query rows a block, two
# consumer warpgroups of 256 output columns each, 32 keys a tile, rows in
# eight 64-column panels
D512_BQ, D512_BK, D512_D = 64, 32, 512
D512_THREADS = 384
# K3 (csrc/flash_bwd_sm90.cu): 128 keys a block (two consumer warpgroups
# of 64), query tiles of 64 rows
K3_BK, K3_BQ, K3_D = 128, 64, 64
K3_THREADS = 384


def _check_launch(bsz, heads, sq, kv, head_dim, row, what):
    if min(bsz, heads, sq) < 1 or kv < 1:
        raise ValueError(f'{what}: empty launch (B {bsz}, H {heads}, '
                         f'Sq {sq}, live keys {kv})')
    if row < heads * head_dim:
        raise ValueError(f'{what}: row stride {row} < {heads} heads '
                         f'x {head_dim}')
    if row * 2 % 16:
        raise ValueError(f'{what}: TMA needs a row pitch that is a '
                         f'multiple of 16 bytes, got {row * 2}')
    if bsz * heads > 65535:
        raise ValueError(f'{what}: B*H = {bsz * heads} > 65535')


def _tmap(width, pitch, rows, box_rows, seq, bsz):
    """A 3-D TMA tensor map over [bsz, seq, row] bf16 read `rows` deep:
    dims and boxes innermost first, strides in bytes of dims 1 and 2."""
    return dict(dims=(width, rows, bsz), strides=(pitch, seq * pitch),
                box=(64, box_rows, 1))


def k1_launch_plan(bsz: int, heads: int, sq: int, sk: int, kv_valid: int,
                   head_dim: int = 64, row_stride: int | None = None) -> dict:
    """What the d=64 forward launches for bf16 q [bsz, sq, row], k/v
    [bsz, sk, row] with head h at column h*64 of rows `row_stride`
    elements apart (heads*64 when packed, as `_launch` passes them; the
    entry point takes any stride): the 3-D TMA tensor maps
    (dims and boxes innermost first, strides in bytes of dims 1 and 2),
    the grid, and the live key tiles. kv_valid is clipped to sk, as the
    entry point clips it; the K/V maps end there, so no tile past it is
    loaded. Raises ValueError on what the kernel does not take."""
    row = heads * head_dim if row_stride is None else row_stride
    kv = min(kv_valid, sk)
    if head_dim != K1_D:
        raise ValueError(f'the d=64 flash kernel takes head_dim 64, not '
                         f'{head_dim}')
    _check_launch(bsz, heads, sq, kv, head_dim, row, 'flash kernel')
    width, pitch = heads * head_dim, row * 2
    return dict(q=_tmap(width, pitch, sq, K1_BQ, sq, bsz),
                k=_tmap(width, pitch, kv, K1_BK, sk, bsz),
                v=_tmap(width, pitch, kv, K1_BK, sk, bsz),
                o=_tmap(width, pitch, sq, K1_BQ // 2, sq, bsz),
                grid=(-(-sq // K1_BQ), bsz * heads), threads=K1_THREADS,
                kv_valid=kv, live_tiles=-(-kv // K1_BK))


def d512_launch_plan(bsz: int, heads: int, sq: int, sk: int, kv_valid: int,
                     head_dim: int = 512,
                     row_stride: int | None = None) -> dict:
    """What the d=512 forward launches for bf16 q [bsz, sq, row], k/v
    [bsz, sk, row], head h at column h*512: the 3-D tensor maps (eight
    64-column boxes a row: Q in 64-row boxes, K and V in 32-row boxes),
    the grid of 64-row query blocks, the live key tiles; kv_valid clipped
    to sk, the K/V maps ending there. Raises ValueError on what the kernel
    does not take."""
    row = heads * head_dim if row_stride is None else row_stride
    kv = min(kv_valid, sk)
    if head_dim != D512_D:
        raise ValueError(f'the d=512 flash kernel takes head_dim 512, not '
                         f'{head_dim}')
    _check_launch(bsz, heads, sq, kv, head_dim, row, 'd=512 flash kernel')
    width, pitch = heads * head_dim, row * 2
    return dict(q=_tmap(width, pitch, sq, D512_BQ, sq, bsz),
                k=_tmap(width, pitch, kv, D512_BK, sk, bsz),
                v=_tmap(width, pitch, kv, D512_BK, sk, bsz),
                panels=D512_D // 64,
                grid=(-(-sq // D512_BQ), bsz * heads), threads=D512_THREADS,
                kv_valid=kv, live_tiles=-(-kv // D512_BK))


def k3_launch_plan(bsz: int, heads: int, sq: int, sk: int, kv_valid: int,
                   head_dim: int = 64) -> dict:
    """What the d=64 backward launches for bf16 q/o/dO [bsz, sq, heads*64]
    and k/v [bsz, sk, heads*64]: the 3-D tensor maps of q and dO (64-row
    boxes) and of K and V (128-row boxes, ending at kv_valid clipped to
    sk), the main kernel's grid of 128-key blocks, its query tiles, and
    the workspace (4 * (B*H*Sq_pad*66 + B*H*tiles) bytes, Sq_pad = Sq
    rounded up to the query tile: the fp32 dQ, B*H*Sq_pad*64 in the
    kernel's tile order, D and the log2 lse [B*H, Sq_pad], a semaphore per
    query tile). Raises ValueError on what the kernel does not take."""
    kv = min(kv_valid, sk)
    if head_dim != K3_D:
        raise ValueError(f'the flash backward kernel takes head_dim 64, '
                         f'not {head_dim}')
    width = heads * head_dim
    _check_launch(bsz, heads, sq, kv, head_dim, width,
                  'flash backward kernel')
    pitch, bh = width * 2, bsz * heads
    tiles = -(-sq // K3_BQ)
    sq_pad = tiles * K3_BQ
    return dict(q=_tmap(width, pitch, sq, K3_BQ, sq, bsz),
                do=_tmap(width, pitch, sq, K3_BQ, sq, bsz),
                k=_tmap(width, pitch, kv, K3_BK, sk, bsz),
                v=_tmap(width, pitch, kv, K3_BK, sk, bsz),
                grid=(-(-kv // K3_BK), bh), threads=K3_THREADS,
                query_tiles=tiles, sq_pad=sq_pad,
                workspace_bytes=4 * (bh * sq_pad * (K3_D + 2) + bh * tiles),
                kv_valid=kv, live_tiles=-(-kv // K3_BK))


def _launch(q, k, v, heads: int, d: int, c: float, kv_valid: int,
            want_lse: bool = False):
    """Launch the d=64 forward (csrc/flash_fwd_sm90.cu) or the d=512 one
    (csrc/flash_fwd_d512_sm90.cu) on q/k/v whose rows are [S, heads*d]
    with head h at column h*d; returns the output in q's layout (and with
    `want_lse`, d=64 only, the fp32 log-sum-exp [B, heads, Sq])."""
    global PACKED_LAUNCHES, LSE_LAUNCHES, D512_LAUNCHES
    span = ('kernel.K2' if d == 512 else
            'kernel.K2_with_l' if want_lse else 'kernel.K1')
    with annotate(span):
        name = {64: 'star_flash_fwd_d64', 512: 'star_flash_fwd_d512'}.get(d)
        if name is None or (want_lse and d != 64):
            raise ValueError(f'flash kernel takes head_dim 64 or 512 '
                             f'(lse: 64 only), not {d}')
        _build.refuse_grad(name, q, k, v)
        for t in (q, k, v):
            if not t.is_cuda or t.dtype != torch.bfloat16:
                raise ValueError('flash kernel takes bf16 CUDA tensors, got '
                                 f'{t.dtype} on {t.device}')
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError('flash kernel takes contiguous 16-byte '
                                 'aligned q/k/v')
        if k.shape != v.shape or k.shape[0] != q.shape[0] \
                or k.shape[2:] != q.shape[2:]:
            raise ValueError(f'flash kernel: q {tuple(q.shape)} k '
                             f'{tuple(k.shape)} v {tuple(v.shape)}')
        bsz, sq = q.shape[0], q.shape[1]
        sk = k.shape[1]
        row = heads * d
        plan = (k1_launch_plan if d == 64 else d512_launch_plan)(
            bsz, heads, sq, sk, kv_valid)
        out = torch.empty_like(q)
        strides = (bsz, heads, sq, sk, plan['kv_valid'],
                   sq * row, sk * row, sk * row, sq * row, row, row, row,
                   row, float(c), _build.stream_ptr(q.device))
        fn = getattr(_build.lib(), name)
        if d == 64:
            lse = (torch.empty((bsz, heads, sq), dtype=torch.float32,
                               device=q.device) if want_lse else None)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), None if lse is None else lse.data_ptr(),
                     *strides)
        else:
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), *strides)
        _build.check(err, name)
        if d == 512:
            D512_LAUNCHES += 1
        elif want_lse:
            LSE_LAUNCHES += 1
            return out, lse
        else:
            PACKED_LAUNCHES += 1
        return out


@spanned('kernel.K3')
def _launch_bwd(q, k, v, o, lse, do, heads: int, scale: float,
                kv_valid: int):
    """Launch csrc/flash_bwd_sm90.cu (K3: the D/lse preprocess, the main
    kernel and the dQ conversion, one call); q/o/do [B, Sq, H*64], k/v
    [B, Sk, H*64], lse [B, H, Sq] fp32. Key rows >= kv_valid get zero
    gradients."""
    global BWD_LAUNCHES
    bsz, sq, c = q.shape
    sk = k.shape[1]
    if c != heads * 64:
        raise ValueError(f'flash backward kernel takes head_dim 64, got '
                         f'{c} channels in {heads} heads')
    for t in (q, k, v, o, do):
        if not t.is_cuda or t.dtype != torch.bfloat16 \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('flash backward kernel takes contiguous '
                             '16-byte aligned bf16 CUDA tensors')
    if k.shape != v.shape or k.shape[0] != bsz or k.shape[2] != c \
            or o.shape != q.shape or do.shape != q.shape \
            or lse.shape != (bsz, heads, sq):
        raise ValueError(f'flash backward kernel: q {tuple(q.shape)} k '
                         f'{tuple(k.shape)} lse {tuple(lse.shape)}')
    plan = k3_launch_plan(bsz, heads, sq, sk, kv_valid)
    kv = plan['kv_valid']
    lse = lse.float().contiguous()
    ws = torch.empty(plan['workspace_bytes'], dtype=torch.uint8,
                     device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if kv < sk:     # the kernel writes the live key rows only
        dk[:, kv:].zero_()
        dv[:, kv:].zero_()
    err = _build.lib().star_flash_bwd_d64(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ws.data_ptr(), bsz, heads, sq, sk, kv, sq * c,
        sk * c, c, float(scale), _build.stream_ptr(q.device))
    _build.check(err, 'star_flash_bwd_d64')
    BWD_LAUNCHES += 1
    return dq, dk, dv


class _FlashAttentionD64(torch.autograd.Function):
    """Packed d=64 attention under autograd: K2 `with_l` forward (saves q,
    k, v, o and the lse), K3 backward; their plain versions for CPU
    tensors. `scale` is the natural one (ln 2 for a prescaled q)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float, kv_valid: int):
        if q.is_cuda:
            out, lse = _launch(q, k, v, num_heads, q.shape[-1] // num_heads,
                               scale * LOG2E, kv_valid, want_lse=True)
        else:
            out, lse = flash_attention_packed_plain(
                q, k, v, num_heads, scale, kv_valid, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads, ctx.scale, ctx.kv_valid = num_heads, scale, kv_valid
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        h, s, kv = ctx.num_heads, ctx.scale, ctx.kv_valid
        if q.is_cuda:
            dq, dk, dv = _launch_bwd(q, k, v, out, lse, do.contiguous(), h,
                                     s, kv)
        else:   # dead key rows carry no gradient
            dq, dk, dv = flash_bwd_plain(q, k[:, :kv], v[:, :kv], out, lse,
                                         do, h, s)
            pad = (0, 0, 0, k.shape[1] - dk.shape[1])
            dk, dv = F.pad(dk, pad), F.pad(dv, pad)
        return dq, dk, dv, None, None, None


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int, scale: float | None = None,
                           kv_valid: int | None = None,
                           prescaled: bool = False) -> torch.Tensor:
    """K1. q/k/v [B, S, H*D] -> [B, S, H*D], non-causal softmax attention
    per head; keys >= kv_valid get no weight; with `prescaled` q already
    carries scale*log2(e). Differentiable: under grad, K2 `with_l` + K3."""
    d = q.shape[-1] // num_heads
    s = (1.0 / math.sqrt(d)) if scale is None else scale
    kv = k.shape[1] if kv_valid is None else min(kv_valid, k.shape[1])
    if _build.needs_grad(q, k, v):
        return _FlashAttentionD64.apply(q, k, v, num_heads,
                                        LN2 if prescaled else s, kv)
    if q.is_cuda:
        return _launch(q, k, v, num_heads, d,
                       1.0 if prescaled else s * LOG2E, kv)
    return flash_attention_packed_plain(q, k, v, num_heads, s, kv_valid,
                                        prescaled)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """K2. q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D].
    Differentiable at d=64 (K2 `with_l` + K3) and on the CPU; the d=512
    kernel raises under grad."""
    b, sq, h, d = q.shape
    s = (1.0 / math.sqrt(d)) if scale is None else scale
    if _build.needs_grad(q, k, v) and (d == 64 or not q.is_cuda):
        flat = lambda t: t.reshape(t.shape[0], t.shape[1], h * d)
        out = _FlashAttentionD64.apply(flat(q), flat(k), flat(v), h, s,
                                       k.shape[1])
        return out.reshape(b, sq, h, d)
    if q.is_cuda:
        return _launch(q, k, v, h, d, s * LOG2E, k.shape[1])
    return attention_plain(q, k, v, s)
