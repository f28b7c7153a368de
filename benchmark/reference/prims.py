"""Plain float32 building blocks of the benchmark's references.

Every product (linear layer, convolution, attention) goes through a
`Precision`: float32 with TF32 off, or the control, which computes each
product as an fp8 training recipe does: both operands rounded to float8
e4m3 and accumulated in float32, and under autograd the gradient that
comes back to the product's output rounded to float8 e5m2 before the
backward products take it; each rounding with one scale a tensor, from
its largest magnitude. The operands' rounding passes the gradient
through unchanged. Tensors are channels-last, as the program's are.
Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # largest finite float8 e4m3fn
FP8_GRAD_MAX = 57344.0   # largest finite float8 e5m2


def round_fp8(t: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """t rounded to `fmt` with one scale, from its largest magnitude."""
    top = FP8_MAX if fmt == torch.float8_e4m3fn else FP8_GRAD_MAX
    amax = t.abs().amax().float().clamp(min=1e-30)
    s = top / amax
    return (t * s).to(fmt).to(t.dtype) / s


class _Operand(torch.autograd.Function):
    """A product's operand in e4m3; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, t):
        return round_fp8(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    """A product's output unchanged; its gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2)


class Precision:
    """fp8=False: float32 products; fp8=True: the float8 control."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """A product's operand."""
        if not self.fp8:
            return t
        return _Operand.apply(t) if torch.is_grad_enabled() \
            else round_fp8(t)

    def g(self, t: torch.Tensor) -> torch.Tensor:
        """A product's output, whose gradient the backward products take."""
        if not self.fp8 or not torch.is_grad_enabled():
            return t
        return _Output.apply(t)

    def qg(self, t: torch.Tensor) -> torch.Tensor:
        """A gradient taken by a product inside a hand-written backward."""
        return round_fp8(t, torch.float8_e5m2) if self.fp8 else t


FP32 = Precision()


def set_fp32_matmul() -> None:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


def linear(p: Precision, x, w, b=None):
    y = p.g(torch.matmul(p.q(x), p.q(w).t()))
    return y if b is None else y + b


def conv2d(p: Precision, x, w, b=None, stride=1, padding=0):
    """x [N, H, W, C], w OIHW -> [N, H', W', O]."""
    y = p.g(F.conv2d(p.q(x).permute(0, 3, 1, 2), p.q(w), b, stride,
                     padding))
    return y.permute(0, 2, 3, 1)


def tconv3(p: Precision, x, w, b):
    """(3,1,1) conv over frames with zero padding: x [B, F, N, C],
    w [3, 1, C, Cout] -> [B, F, N, Cout]."""
    f = x.shape[1]
    xp = F.pad(p.q(x), (0, 0, 0, 0, 1, 1))
    wq = p.q(w)[:, 0]
    y = sum(torch.matmul(xp[:, i:i + f], wq[i]) for i in range(3))
    return p.g(y) + b


def group_norm(x, w, b, groups=32, eps=1e-5):
    """Statistics over every axis but the first and per group of channels
    (x [N, ..., C])."""
    n, c = x.shape[0], x.shape[-1]
    xg = x.reshape(n, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * w + b


def layer_norm(x, w, b, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def attention(p: Precision, q, k, v, heads: int, scale: float | None = None,
              mask=None, budget: int = 1 << 28):
    """Softmax attention per head: q [B, Sq, H*D], k/v [B, Sk, H*D] ->
    [B, Sq, H*D], in blocks of query rows so that at most `budget` logits
    live at once."""
    bsz, sq, c = q.shape
    sk = k.shape[1]
    d = c // heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qh = p.q(q).reshape(bsz, sq, heads, d).transpose(1, 2)
    kh = p.q(k).reshape(bsz, sk, heads, d).transpose(1, 2)
    vh = p.q(v).reshape(bsz, sk, heads, d).transpose(1, 2)
    out = torch.empty_like(qh)
    rows = max(1, min(sq, budget // (bsz * heads * sk)))
    for i in range(0, sq, rows):
        logits = p.g(torch.matmul(qh[:, :, i:i + rows],
                                  kh.transpose(-1, -2)))
        logits = logits * scale
        if mask is not None:
            logits = logits + mask[i:i + rows]
        probs = torch.softmax(logits, dim=-1)
        out[:, :, i:i + rows] = p.g(torch.matmul(p.q(probs), vh))
    return out.transpose(1, 2).reshape(bsz, sq, c)


def silu(x):
    return F.silu(x)


class Weights:
    """float32 views of a state dict under a prefix: w('conv_in.weight')."""

    def __init__(self, sd: dict, prefix: str = ''):
        self.sd, self.prefix = sd, prefix

    def __call__(self, name: str) -> torch.Tensor:
        return self.sd[self.prefix + name].float()

    def has(self, name: str) -> bool:
        return self.prefix + name in self.sd

    def sub(self, name: str) -> 'Weights':
        return Weights(self.sd, f'{self.prefix}{name}.')
