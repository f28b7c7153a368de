"""LayerNorm over the last axis, optionally LIEM-gated: kernel K10; and the
residual add + [LIEM gate +] LayerNorm: kernel K11 (counterparts of
tools/negative_results/fused_ln.py and tools/negative_results/stream_fuse.py).

For every row of x [..., C]: fp32 statistics mean and
var = max(E[x^2] - mean^2, 0); with `gate_w` [2] the TemporalLIEM gate
g = sigmoid(w0 * max_c(x) + w1 * mean_c(x)) folded into the coefficients
(LN(g x) = (x - mean) * g * rsqrt(g^2 var + eps) * scale + bias), so the
gated tensor is never formed; the apply in fp32 with one rounding to
x.dtype. K11 first forms xr = y + resid in y.dtype (one rounding, PyTorch's
own add), normalises xr and returns (normed, xr).

A CUDA tensor goes through csrc/fused_ln.cu (bf16, contiguous, C a
multiple of 64 up to 4096; anything else raises), whose path by width is
`ln_launch_plan`; a CPU tensor through the plain version. Under autograd
both are torch.autograd.Functions whose backward recomputes the plain
version from the saved inputs and differentiates it, on CUDA tensors too,
as the JAX package's custom VJPs recompute through their references
(fused_ln.py:168-199, stream_fuse.py:210-218); there is no backward
kernel. Gradients reach x, resid, scale, bias and the gate weights.
"""

from __future__ import annotations

import torch

from ..utils.profiling import spanned
from . import _build

LN_LAUNCHES = 0          # K10
RESID_LN_LAUNCHES = 0    # K11

# csrc/fused_ln.cu: one warp a row, 4 rows a block; rows of C >= LN_WIDE
# take the 16-byte path, its register array sized to the exact C for the
# widths in LN_EXACT (vectors of 8 a lane) and generic (16) for the others
LN_THREADS = 128
LN_WIDE = 1024
LN_EXACT = {1024: 4, 1280: 5, 3072: 12}


def ln_launch_plan(rows: int, c: int) -> dict:
    """What csrc/fused_ln.cu launches for `rows` rows of C values: the path
    ('pairs': bf16x2 steps, C/64 a lane in a bucket of 8 or 16; 'vec16':
    16-byte vectors of 8 bf16, C/256 a lane), the registers of row data a
    lane holds (`per_lane`, in pairs or vectors), whether that array is
    sized to the exact C, the alignment in bytes every tensor needs, and
    the grid. Raises ValueError on a width the kernels do not take."""
    if c % 64 or not 64 <= c <= 4096:
        raise ValueError(f'fused LayerNorm kernels take C a multiple of 64 '
                         f'up to 4096, got {c}')
    if c < LN_WIDE:
        plan = dict(path='pairs', per_lane=8 if c <= 512 else 16,
                    exact=False, align=4)
    else:
        plan = dict(path='vec16', per_lane=LN_EXACT.get(c, 16),
                    exact=c in LN_EXACT, align=16)
    rows_per_block = LN_THREADS // 32
    return dict(plan, threads=LN_THREADS,
                blocks=-(-rows // rows_per_block))


def _norm_plain(x, scale, bias, eps, gate_w):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp(x32.square().mean(-1, keepdim=True) - mean.square(),
                      min=0.0)
    if gate_w is None:
        a = torch.rsqrt(var + eps)
    else:
        gw = gate_w.float().reshape(2)
        g = torch.sigmoid(x32.amax(-1, keepdim=True) * gw[0] + mean * gw[1])
        a = g * torch.rsqrt(var * g.square() + eps)
    return ((x32 - mean) * a * scale.float() + bias.float()).to(x.dtype)


def fused_ln_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5,
                   gate_w: torch.Tensor | None = None) -> torch.Tensor:
    """K10's plain version: x [..., C] -> [..., C] in x.dtype."""
    return _norm_plain(x, scale, bias, eps, gate_w)


def fused_resid_ln_plain(y: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor,
                         resid: torch.Tensor | None = None,
                         gate_w: torch.Tensor | None = None,
                         eps: float = 1e-5):
    """K11's plain version: (normed, xr = y + resid), or (normed, None)
    without a residual."""
    xr = y if resid is None else y + resid
    return _norm_plain(xr, scale, bias, eps, gate_w), \
        (None if resid is None else xr)


def _kernel_args(name, x, scale, bias, gate_w, others=()):
    """Checks what the kernels take; returns (rows, C, scale, bias, gate_w,
    pbf) with the parameters all bf16 (pbf 1) when the module holds them so,
    else all fp32 (pbf 0)."""
    c = x.shape[-1]
    for t in (x, *others):
        if not t.is_cuda or t.dtype != torch.bfloat16 \
                or not t.is_contiguous() or t.shape != x.shape:
            raise ValueError(f'{name} kernel takes contiguous bf16 CUDA '
                             f'tensors of one shape, got {t.dtype} '
                             f'{tuple(t.shape)} on {t.device}')
    align = ln_launch_plan(x.numel() // c, c)['align']
    if any(t.data_ptr() % align for t in (x, *others)):
        raise ValueError(f'{name} kernel at C={c} takes {align}-byte '
                         'aligned tensors')
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,) \
            or (gate_w is not None and gate_w.numel() != 2):
        raise ValueError(f'{name} kernel takes [C] scale and bias and [2] '
                         'gate weights')
    params = [t for t in (scale, bias, gate_w) if t is not None]
    pbf = all(t.dtype == torch.bfloat16 for t in params)
    dt = torch.bfloat16 if pbf else torch.float32
    sc, bi, gw = (None if t is None else
                  t.to(device=x.device, dtype=dt).reshape(-1).contiguous()
                  for t in (scale, bias, gate_w))
    if sc.data_ptr() % align or bi.data_ptr() % align:
        raise ValueError(f'{name} kernel at C={c} takes {align}-byte '
                         'aligned scale and bias')
    return x.numel() // c, c, sc, bi, gw, int(pbf)


@spanned('kernel.K10')
def _launch_ln(x, scale, bias, eps, gate_w):
    global LN_LAUNCHES
    rows, c, sc, bi, gw, pbf = _kernel_args('fused_ln', x, scale, bias,
                                            gate_w)
    out = torch.empty_like(x)
    if rows:
        err = _build.lib().star_fused_ln(
            x.data_ptr(), sc.data_ptr(), bi.data_ptr(),
            None if gw is None else gw.data_ptr(), pbf, out.data_ptr(), rows,
            c, float(eps), _build.stream_ptr(x.device))
        _build.check(err, 'star_fused_ln')
        LN_LAUNCHES += 1
    return out


@spanned('kernel.K11')
def _launch_resid_ln(y, resid, scale, bias, eps, gate_w):
    global RESID_LN_LAUNCHES
    rows, c, sc, bi, gw, pbf = _kernel_args('fused_resid_ln', y, scale, bias,
                                            gate_w, (resid,))
    out, xr = torch.empty_like(y), torch.empty_like(y)
    if rows:
        err = _build.lib().star_fused_resid_ln(
            y.data_ptr(), resid.data_ptr(), sc.data_ptr(), bi.data_ptr(),
            None if gw is None else gw.data_ptr(), pbf, out.data_ptr(),
            xr.data_ptr(), rows, c, float(eps), _build.stream_ptr(y.device))
        _build.check(err, 'star_fused_resid_ln')
        RESID_LN_LAUNCHES += 1
    return out, xr


def _ln(x, scale, bias, eps, gate_w, plain=False):
    """K10 for a CUDA tensor unless `plain`, else the plain version."""
    if x.is_cuda and not plain:
        return _launch_ln(x, scale, bias, eps, gate_w)
    return fused_ln_plain(x, scale, bias, eps, gate_w)


def _resid_ln(y, resid, scale, bias, eps, gate_w, plain=False):
    """K11 for a CUDA tensor unless `plain`, else the plain version."""
    if y.is_cuda and not plain:
        return _launch_resid_ln(y, resid, scale, bias, eps, gate_w)
    return fused_resid_ln_plain(y, scale, bias, resid, gate_w, eps)


def _recompute_grads(ctx, fn, cts):
    """Gradients of the saved inputs that need them: the plain version
    recomputed from them under grad and differentiated against `cts`."""
    inputs = [t.detach().requires_grad_() if t is not None and need else t
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    live = [t for t in inputs if t is not None and t.requires_grad]
    with torch.enable_grad():
        outs = fn(*inputs)
        grads = iter(torch.autograd.grad(outs, live, cts, allow_unused=True))
    return [next(grads) if t is not None and t.requires_grad else None
            for t in inputs]


class _FusedLN(torch.autograd.Function):
    """K10 forward (the plain version on the CPU, or with `plain`, which the
    tests use to hold the Function itself); the backward recomputes the
    plain version and differentiates it."""

    @staticmethod
    def forward(ctx, x, scale, bias, gate_w, eps, plain):
        ctx.save_for_backward(x, scale, bias, gate_w)
        ctx.eps = eps
        return _ln(x, scale, bias, eps, gate_w, plain)

    @staticmethod
    def backward(ctx, ct):
        grads = _recompute_grads(
            ctx, lambda x, sc, bi, gw: fused_ln_plain(x, sc, bi, ctx.eps, gw),
            [ct])
        return (*grads, None, None)


class _FusedResidLN(torch.autograd.Function):
    """K11 forward (the plain version on the CPU) -> (normed, xr); the
    backward recomputes the plain version and differentiates both outputs."""

    @staticmethod
    def forward(ctx, y, resid, scale, bias, gate_w, eps, plain):
        ctx.save_for_backward(y, resid, scale, bias, gate_w)
        ctx.eps = eps
        return _resid_ln(y, resid, scale, bias, eps, gate_w, plain)

    @staticmethod
    def backward(ctx, ct_normed, ct_xr):
        grads = _recompute_grads(
            ctx, lambda y, r, sc, bi, gw: fused_resid_ln_plain(
                y, sc, bi, r, gw, ctx.eps), [ct_normed, ct_xr])
        return (*grads, None, None)


def fused_ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float = 1e-5,
             gate_w: torch.Tensor | None = None) -> torch.Tensor:
    """K10: LayerNorm over the last axis of x [..., C], after the LIEM gate
    when `gate_w` [2] (w0 -> channel max, w1 -> channel mean) is given.
    Differentiable (plain recompute backward)."""
    if _build.needs_grad(x, scale, bias, gate_w):
        return _FusedLN.apply(x, scale, bias, gate_w, eps, False)
    return _ln(x, scale, bias, eps, gate_w)


def fused_resid_ln(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   resid: torch.Tensor | None = None,
                   gate_w: torch.Tensor | None = None, eps: float = 1e-5):
    """K11: xr = y + resid, then K10's (gated) LayerNorm of xr, in one pass.
    Returns (normed, xr); without a residual this is K10's function, run by
    K10, and returns (normed, None). Differentiable (plain recompute
    backward)."""
    if resid is None:
        return fused_ln(y, scale, bias, eps, gate_w), None
    if _build.needs_grad(y, resid, scale, bias, gate_w):
        normed, xr = _FusedResidLN.apply(y, resid, scale, bias, gate_w, eps,
                                         False)
        return normed, xr
    return _resid_ln(y, resid, scale, bias, eps, gate_w)
